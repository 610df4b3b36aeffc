"""Weight initializers and TF-style dropout.

glorot is the Glorot & Bengio uniform with limit
sqrt(6/(fan_in+fan_out)), as in the reference's initializers. Draws
come from an explicit CPU ``torch.Generator`` and are then moved to the
device, so the same seed gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch


def glorot(generator: torch.Generator, shape, device="cpu",
           dtype=torch.float32) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                 generator=generator)
    return w.to(device)


def zeros(shape, device="cpu", dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """TF-style dropout: zero with prob ``rate``, scale kept by
    1/(1-rate), in ``x``'s dtype. ``generator`` lives on ``x``'s device.
    ``keep`` is rounded to that dtype first, as JAX rounds the weakly
    typed ``x / keep``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    keep_x = float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(mask, x / keep_x, torch.zeros_like(x))
