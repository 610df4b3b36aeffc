"""The numbers the output check compares with their limits.

- ``leaf_gaps``: for each parameter leaf, the gap between the
  program's norm of the leaf and the reference's, against the larger of
  the reference's norm of that leaf and of the median leaf (some
  gradients are all but zero).
- ``log_gap``: the widest gap between the program's log predictions and
  the reference's.
"""

from __future__ import annotations

import statistics

import torch


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """{leaf: gap} over the leaves in ``keep`` (all without it)."""
    keys = [k for k in reference if keep is None or k in keep]
    median = statistics.median(reference[k] for k in keys)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median,
                                                    1e-30)
            for k in keys}


def moved_leaves(grad_norms: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= share * median}


def log_gap(preds: torch.Tensor, ref_log: torch.Tensor) -> float:
    """max |log p - log p_ref| over the rows given; a prediction of 0 or
    a non-finite one reads 1e30."""
    gap = (torch.log(preds.double()) - ref_log.double()).abs()
    gap = torch.nan_to_num(gap, nan=1e30, posinf=1e30)
    return float(gap.max()) if gap.numel() else 0.0
