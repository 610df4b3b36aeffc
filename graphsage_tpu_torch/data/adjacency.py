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

``pad_neighbor_lists`` takes the C++ builder (``data/native.py``) first,
as the JAX package does, and ``numpy_pad_neighbor_lists`` where the
library is unavailable; the two draw different neighbors.
"""

from __future__ import annotations

import numpy as np

from graphsage_tpu_torch.data import native
from graphsage_tpu_torch.data.graph import GraphData


def pad_neighbor_lists(
    neighbors: list,
    n: int,
    max_degree: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (adj [n+1, max_degree] int32, deg [n] int32). One draw of
    ``rng`` seeds the C++ builder; without it the NumPy path goes on
    drawing from ``rng``."""
    deg = np.asarray([len(x) for x in neighbors], dtype=np.int32)
    seed = int(rng.integers(0, 2**31 - 1))
    adj = native.native_pad_adjacency(neighbors, n, max_degree, seed)
    if adj is None:
        adj = numpy_pad_neighbor_lists(neighbors, n, max_degree, rng)
    return adj, deg


def numpy_pad_neighbor_lists(neighbors: list, n: int, max_degree: int,
                             rng: np.random.Generator) -> np.ndarray:
    """The NumPy path: [n+1, max_degree] int32, rows drawn from ``rng``
    as the JAX package's NumPy path draws them after its seed draw."""
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
    return adj


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
