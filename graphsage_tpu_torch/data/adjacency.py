"""Padded dense adjacency construction.

The device-side sampler reads a dense [N+1, max_degree] int32 matrix:
row i holds max_degree neighbor indices of node i (drawn with
replacement if deg < max_degree, without replacement if
deg > max_degree), and row N, the dummy node, points at itself so that
zero-degree nodes aggregate the zero feature row.

Two variants:
  * train adjacency: val/test nodes get all-dummy rows; only non
    ``train_removed`` edges contribute; also returns train degrees.
  * full ("test") adjacency: every node, every edge.
"""

from __future__ import annotations

import numpy as np

from graphsage_tpu_torch.data.graph import GraphData


def pad_neighbor_lists(
    neighbors: list,
    n: int,
    max_degree: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (adj [n+1, max_degree] int32, deg [n] int32)."""
    deg = np.asarray([len(x) for x in neighbors], dtype=np.int32)
    # graphsage_tpu spends one draw here (the seed of its C++ builder)
    # before its NumPy path; spending it too keeps the two packages'
    # adjacencies equal for the same seed
    rng.integers(0, 2**31 - 1)
    adj = np.full((n + 1, max_degree), n, dtype=np.int32)
    for i, nbrs in enumerate(neighbors):
        d = len(nbrs)
        if d == 0:
            continue
        if d > max_degree:
            adj[i] = rng.choice(nbrs, size=max_degree, replace=False)
        elif d < max_degree:
            adj[i] = rng.choice(nbrs, size=max_degree, replace=True)
        else:
            adj[i] = nbrs
    return adj, deg


def build_both_adjs(
    graph: GraphData,
    max_degree: int,
    seed: int = 123,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_adj, train_deg, full_adj), drawn from one RNG stream in
    that order."""
    rng = np.random.default_rng(seed)
    n = graph.num_nodes
    train_adj, deg = pad_neighbor_lists(
        graph.train_neighbors(), n, max_degree, rng
    )
    full_adj, _ = pad_neighbor_lists(graph.neighbors, n, max_degree, rng)
    return train_adj, deg, full_adj
