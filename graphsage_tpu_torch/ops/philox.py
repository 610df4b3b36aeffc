"""Philox4x32-10 and the dropout mask of K2, in plain PyTorch integers.

K2 (``fused_gather_mean`` with ``drop_rate > 0``) draws its mask with a
counter-based generator written into the CUDA kernel
(``csrc/gather_mean.cu``). This module is its plain version: the same
bits, computed with int64 tensors (PyTorch has no unsigned 32x32->64
multiply, so one factor is split into 16-bit halves). The mapping from
an element of the gathered rows to its random word is defined here once
and the kernel follows it:

  element (r, f) of the [R, F] gathered rows, r = b * S + s
  group    g = r * ceil(F / 4) + f // 4            (64-bit)
  counter  (g & 0xffffffff, g >> 32, step, tag)
  key      (seed & 0xffffffff, seed >> 32)
  bits     word f % 4 of philox4x32_10(counter, key)
  kept     iff bits < dropout_threshold(rate); kept values are scaled
           by float32(1 / (1 - rate))

``step`` is the training step (each step draws its own mask) and
``tag`` names the call site, so that two masks of one step never share
a stream.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, for a uint32
    constant ``a`` and an int64 tensor ``b`` holding uint32 values."""
    x = a * (b & 0xFFFF)          # < 2**48
    y = a * (b >> 16)             # < 2**48
    lo = (((y & 0xFFFF) << 16) + x) & MASK32
    hi = (y + (x >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key: tuple[int, int]):
    """Random123's Philox4x32: four int64 tensors (uint32 values) of
    counter words and a two-word key -> the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """uint32 t with P(bits < t) = 1 - rate for uniform 32-bit bits."""
    return min(int((1.0 - rate) * 4294967296.0), MASK32)


def dropout_scale(rate: float) -> float:
    """The scale of kept values, as the float32 the kernel receives."""
    return float(np.float32(1.0 / (1.0 - rate)))


def check_stream(seed: int, step: int, tag: int) -> None:
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    if not (0 <= step <= MASK32 and 0 <= tag <= MASK32):
        raise ValueError(
            f"step and tag must be in [0, 2**32), got {step} and {tag}"
        )


def dropout_bits(n_rows: int, F: int, seed: int, step: int, tag: int,
                 device="cpu") -> torch.Tensor:
    """[n_rows, F] int64 tensor of the uint32 random words of each
    element of [n_rows, F] gathered rows."""
    check_stream(seed, step, tag)
    G = -(-F // 4)
    g = torch.arange(n_rows * G, dtype=torch.int64, device=device)
    words = philox4x32(
        (g & MASK32, g >> 32, torch.full_like(g, step),
         torch.full_like(g, tag)),
        (seed & MASK32, seed >> 32),
    )
    return torch.stack(words, dim=-1).view(n_rows, 4 * G)[:, :F]


def dropout_keep_mask(n_rows: int, F: int, rate: float, seed: int,
                      step: int, tag: int, device="cpu") -> torch.Tensor:
    """[n_rows, F] bool: True where the element is kept."""
    bits = dropout_bits(n_rows, F, seed, step, tag, device)
    return bits < dropout_threshold(rate)


def philox_dropout(x: torch.Tensor, rate: float, seed: int, step: int,
                   tag: int) -> torch.Tensor:
    """Dropout of a 2-D [R, F] tensor by the mask above, in ``x``'s
    dtype: zero where dropped, ``x * scale`` where kept."""
    if rate == 0.0:
        return x
    keep = dropout_keep_mask(x.shape[0], x.shape[1], rate, seed, step, tag,
                             x.device)
    return torch.where(keep, x * dropout_scale(rate), torch.zeros_like(x))
