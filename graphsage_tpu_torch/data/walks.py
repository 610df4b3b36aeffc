"""Random-walk co-occurrence pairs, on the host.

The reference's walk generator: ``num_walks`` walks of length
``walk_len`` from each start node, emitting (start, visited) pairs and
skipping the start itself. ``run_random_walks`` takes the C++ builder
(``data/native.py``) first, as the JAX package does, seeded by one draw
of the caller's generator; ``python_random_walks``, where the library is
unavailable, draws the same pairs as the JAX package's Python walker for
the same NumPy ``Generator``.
"""

from __future__ import annotations

import numpy as np

from graphsage_tpu_torch.data import native

WALK_LEN = 5
N_WALKS = 50


def run_random_walks(
    neighbors: list,
    nodes: np.ndarray,
    num_walks: int = N_WALKS,
    walk_len: int = WALK_LEN,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """[W, 2] int32 (start, visited) pairs.

    ``neighbors`` is a list of int32 arrays: the adjacency of whatever
    subgraph the caller walks (the reference walks the train-node
    subgraph).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    pairs = native.native_random_walks(
        neighbors, np.asarray(nodes, dtype=np.int32), num_walks, walk_len,
        int(rng.integers(0, 2**31 - 1)))
    if pairs is None:
        pairs = python_random_walks(neighbors, nodes, num_walks, walk_len,
                                    rng)
    return pairs


def python_random_walks(neighbors: list, nodes: np.ndarray, num_walks: int,
                        walk_len: int, rng: np.random.Generator
                        ) -> np.ndarray:
    """The Python walker: [W, 2] int32 pairs drawn from ``rng``."""
    pairs = []
    for node in nodes:
        if len(neighbors[node]) == 0:
            continue
        for _ in range(num_walks):
            curr = node
            for _ in range(walk_len):
                curr_nbrs = neighbors[curr]
                if len(curr_nbrs) == 0:
                    break
                nxt = int(curr_nbrs[rng.integers(len(curr_nbrs))])
                if curr != node:
                    pairs.append((node, curr))
                curr = nxt
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def write_walks(path: str, pairs: np.ndarray, node_ids: list) -> None:
    """Pairs as the reference's tab-separated walks file, in original
    node ids."""
    with open(path, "w") as fp:
        fp.write("\n".join(f"{node_ids[a]}\t{node_ids[b]}"
                           for a, b in pairs))


def read_walks(path: str, id2idx: dict) -> np.ndarray:
    """A walks file -> [W, 2] int32 index pairs."""
    pairs = []
    conv = int if isinstance(next(iter(id2idx)), int) else (lambda x: x)
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) != 2:
                continue
            pairs.append((id2idx[conv(parts[0])], id2idx[conv(parts[1])]))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
