"""On-device uniform neighbor sampling over the padded adjacency.

Modes:
  * ``shared_perm`` (default): one column permutation of the
    max_degree columns per call, shared by every row, then the first
    ``num_samples`` columns: the reference's sampler semantics.
  * ``first_k``: the first ``num_samples`` columns, deterministic (for
    parity tests).
  * ``independent``: per-node i.i.d. column draws.

Padded rows repeat neighbors when deg < max_degree, so a uniform column
draw is a uniform draw over the node's neighbor multiset in every mode.
The permutation comes from torch's generator, so its bits differ from
the JAX package's; the semantics are the same.
"""

from __future__ import annotations

import torch


def uniform_sample(generator: torch.Generator | None, adj: torch.Tensor,
                   ids: torch.Tensor, num_samples: int,
                   mode: str = "shared_perm") -> torch.Tensor:
    """[n, num_samples] neighbor indices of ``ids`` from the padded
    [N+1, max_degree] int32 adjacency."""
    return sample_from_rows(generator, adj.index_select(0, ids),
                            num_samples, mode)


def sample_from_rows(generator: torch.Generator | None, rows: torch.Tensor,
                     num_samples: int,
                     mode: str = "shared_perm") -> torch.Tensor:
    """Sample ``num_samples`` columns of adjacency rows [n, D].
    ``generator`` lives on ``rows``' device (unused by ``first_k``)."""
    max_degree = rows.shape[1]
    if mode == "shared_perm":
        perm = torch.randperm(max_degree, generator=generator,
                              device=rows.device)
        return rows[:, perm[:num_samples]]
    if mode == "first_k":
        return rows[:, :num_samples]
    if mode == "independent":
        cols = torch.randint(0, max_degree, (rows.shape[0], num_samples),
                             generator=generator, device=rows.device)
        return torch.gather(rows, 1, cols)
    raise ValueError(f"unknown sampler mode {mode!r}")
