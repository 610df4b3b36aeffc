"""Host-side graph container: flat NumPy arrays in id_map index order."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphData:
    """All host-side graph state, in id_map index order.

    Node index ``num_nodes`` is reserved as the "dummy" node: padded
    adjacency rows point at it and its feature row is all zeros, so
    aggregating over it contributes nothing.
    """

    node_ids: list          # original node ids (JSON ids), position = index
    id2idx: dict            # original id -> index
    features: np.ndarray | None   # [N, F] float32 (train-normalized), unpadded
    class_map: dict | None        # original id -> int or list[int]
    labels: np.ndarray | None     # [N, C] float32 dense label matrix
    num_classes: int | None
    is_val: np.ndarray      # [N] bool
    is_test: np.ndarray     # [N] bool
    edges: np.ndarray       # [E, 2] int32 undirected edge list (each once)
    train_removed: np.ndarray     # [E] bool — touches a val/test endpoint
    neighbors: list         # list of [deg_i] int32 arrays, full adjacency
    walks: np.ndarray | None = None   # [W, 2] int32 co-occurrence pairs
    # A deferred feature table (load_data(load_features=False)): the
    # feats file's row of each node index, and (path, file rows, width)
    # of the table on disk while ``features`` is None.
    feat_rows: np.ndarray | None = None
    feature_meta: tuple | None = None
    # the normalize intent of load_data, which deferred loads keep
    feature_normalize: bool = True

    @property
    def num_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def feature_dim(self) -> int:
        """Feature width, whether the table is in memory or deferred."""
        if self.features is not None:
            return self.features.shape[1]
        if self.feature_meta is not None:
            return self.feature_meta[2]
        return 0

    @property
    def is_train(self) -> np.ndarray:
        return ~(self.is_val | self.is_test)

    def padded_features(self) -> np.ndarray | None:
        """Features with one extra all-zero row for the dummy node."""
        if self.features is None:
            return None
        f = self.features
        return np.vstack([f, np.zeros((1, f.shape[1]), dtype=f.dtype)])

    def train_neighbors(self) -> list:
        """Adjacency restricted to train nodes and non-removed edges."""
        n = self.num_nodes
        out: list[list[int]] = [[] for _ in range(n)]
        for a, b in self.edges[~self.train_removed]:
            out[a].append(b)
            out[b].append(a)
        is_train = self.is_train
        return [
            np.asarray(out[i] if is_train[i] else [], dtype=np.int32)
            for i in range(n)
        ]


def dense_labels(class_map: dict, node_ids: list,
                 num_classes: int) -> np.ndarray:
    """A class_map as a dense [N, C] float32 matrix: multilabel lists pass
    through, integer labels become one-hot."""
    out = np.zeros((len(node_ids), num_classes), dtype=np.float32)
    for i, nid in enumerate(node_ids):
        label = class_map[nid]
        if isinstance(label, (list, np.ndarray)):
            out[i] = np.asarray(label, dtype=np.float32)
        else:
            out[i, int(label)] = 1.0
    return out


def infer_num_classes(class_map: dict) -> int:
    """List length for multilabel maps, distinct count otherwise."""
    first = next(iter(class_map.values()))
    if isinstance(first, (list, np.ndarray)):
        return len(first)
    return len(set(class_map.values()))
