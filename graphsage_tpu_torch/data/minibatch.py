"""Supervised node sets and validation batches.

Training batches are slices of a dummy-padded, device-resident id
stream (``parallel/dp.py``); this module gives the node sets behind it
and the sampled validation batches. The random draws come from a NumPy
generator seeded as the JAX package seeds its own, so both packages
draw the same batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphsage_tpu_torch.data.graph import GraphData


@dataclasses.dataclass
class NodeBatch:
    ids: np.ndarray     # [B] int32
    labels: np.ndarray  # [B, C] float32
    mask: np.ndarray    # [B] float32, 1 for real entries


class NodeBatcher:
    """Train/val/test node sets and validation batches.

    Train nodes are the non-val/test nodes with positive train degree.
    """

    def __init__(self, graph: GraphData, deg: np.ndarray, batch_size: int,
                 seed: int = 123):
        self.graph = graph
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

        idx = np.arange(graph.num_nodes)
        self.train_nodes = idx[graph.is_train & (deg > 0)]
        self.val_nodes = idx[graph.is_val]
        self.test_nodes = idx[graph.is_test]

    def num_batches(self) -> int:
        return -(-len(self.train_nodes) // self.batch_size)

    def sample_val_batch(self, size: int) -> NodeBatch:
        """Random with-replacement val sample of ``size`` nodes."""
        nodes = self._rng.choice(self.val_nodes, size=size, replace=True)
        return NodeBatch(ids=nodes.astype(np.int32),
                         labels=self.graph.labels[nodes].astype(np.float32),
                         mask=np.ones((size,), dtype=np.float32))
