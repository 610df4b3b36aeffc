"""Node and edge sets, and the batches drawn from them.

Training batches are slices of a dummy-padded, device-resident id (or
pair) stream (``parallel/dp.py``); this module gives the sets behind it,
the sampled validation batches and the embedding export's self-pairs.
Short batches are padded with the dummy node N and carry a zero mask.
The random draws come from a NumPy generator seeded as the JAX package
seeds its own, so both packages draw the same batches.
"""

from __future__ import annotations

import dataclasses
import warnings

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

    def sample_val_batch(self, size: int,
                         pad_to: int | None = None) -> NodeBatch:
        """Random with-replacement val sample of ``size`` nodes, padded
        with the dummy node (zero mask) up to ``pad_to`` rows (a multiple
        of the shard count under ``--graph_shards``)."""
        nodes = self._rng.choice(self.val_nodes, size=size, replace=True)
        b = max(size, pad_to or 0)
        ids = np.full((b,), self.graph.num_nodes, dtype=np.int32)
        ids[:size] = nodes
        labels = np.zeros((b, self.graph.num_classes), dtype=np.float32)
        labels[:size] = self.graph.labels[nodes]
        mask = np.zeros((b,), dtype=np.float32)
        mask[:size] = 1.0
        return NodeBatch(ids=ids, labels=labels, mask=mask)


@dataclasses.dataclass
class EdgeBatch:
    batch1: np.ndarray  # [B] int32 source node indices
    batch2: np.ndarray  # [B] int32 target/context node indices
    mask: np.ndarray    # [B] float32, 1 for real entries


class EdgeBatcher:
    """Unsupervised pairs: random-walk co-occurrences or edges.

    * train pairs: the walk pairs when given (the reference's
      ``random_context`` default), else the graph's edges; either way
      only pairs whose endpoints both have positive train degree. (The
      reference means to do this; an operator-precedence slip in its
      version also keeps edges to test nodes in raw-edge mode, which is
      not reproduced.)
    * val pairs: the ``train_removed`` edges.
    * ``n2v_retrain``: node2vec's test-time retrain trains (and
      validates) on the given pairs as they are; ``fixed_n2v`` keeps
      only contexts that are train nodes.
    """

    def __init__(self, graph: GraphData, deg: np.ndarray, batch_size: int,
                 context_pairs: np.ndarray | None = None, seed: int = 123,
                 n2v_retrain: bool = False, fixed_n2v: bool = False):
        self.graph = graph
        self.batch_size = batch_size
        self.dummy = graph.num_nodes
        self._rng = np.random.default_rng(seed)

        if context_pairs is not None:
            pairs = np.asarray(context_pairs, dtype=np.int32).reshape(-1, 2)
        else:
            pairs = graph.edges.astype(np.int32)
        if n2v_retrain:
            if fixed_n2v:
                is_evalnode = graph.is_val | graph.is_test
                pairs = pairs[~is_evalnode[pairs[:, 1]]]
            self.train_pairs = pairs
            self.val_pairs = pairs
        else:
            keep = (deg[pairs[:, 0]] > 0) & (deg[pairs[:, 1]] > 0)
            self.train_pairs = pairs[keep]
            self.val_pairs = graph.edges[graph.train_removed].astype(np.int32)
        self.nodes = np.arange(graph.num_nodes, dtype=np.int32)

    def num_batches(self) -> int:
        return -(-len(self.train_pairs) // self.batch_size)

    def sample_val_batch(self, size: int) -> EdgeBatch:
        """A random batch of distinct val pairs, padded to the batch
        size: ``size <= 0`` (the reference's ``validate_batch_size``
        -1) or above the batch size takes one full batch, since the
        batch shape is fixed."""
        if size > self.batch_size:
            warnings.warn(
                f"validate_batch_size {size} exceeds batch_size "
                f"{self.batch_size}; validating on {self.batch_size} "
                f"edges (the fixed batch shape). Raise --batch_size "
                f"or use --validate_batch_size -1 for a full sweep.",
                stacklevel=2,
            )
        if size <= 0 or size > self.batch_size:
            size = self.batch_size
        ind = self._rng.permutation(len(self.val_pairs))[
            : min(size, len(self.val_pairs))
        ]
        return self._make_batch(self.val_pairs[ind], self.batch_size)

    def embed_batches(self):
        """(n, n) self-pairs over every node, for the embedding export."""
        selfpairs = np.stack([self.nodes, self.nodes], axis=1)
        b = self.batch_size
        for start in range(0, len(selfpairs), b):
            yield self._make_batch(selfpairs[start:start + b], b)

    def _make_batch(self, pairs: np.ndarray, b: int) -> EdgeBatch:
        k = len(pairs)
        b1 = np.full((b,), self.dummy, dtype=np.int32)
        b2 = np.full((b,), self.dummy, dtype=np.int32)
        mask = np.zeros((b,), dtype=np.float32)
        if k:
            b1[:k] = pairs[:, 0]
            b2[:k] = pairs[:, 1]
        mask[:k] = 1.0
        return EdgeBatch(batch1=b1, batch2=b2, mask=mask)
