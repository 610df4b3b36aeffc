"""Fused embedding-gather + neighbor mean, with optional dropout.

``fused_gather_mean`` computes ``features[idx].view(B, S, F).mean(1)``
without writing the [B*S, F] gather to memory. With ``drop_rate > 0``
each gathered element is first dropped or scaled by 1/keep, by a mask
drawn from Philox4x32-10 (``ops/philox.py`` defines the bits), and
neither the rows nor the mask reach memory either.

On a CUDA tensor it launches a hand-written kernel in
``csrc/gather_mean.cu``: K1 without dropout, K2 with it (it never falls
back); on a CPU tensor it runs ``gather_mean_reference`` or
``gather_mean_dropout_reference``, the plain PyTorch versions that the
tests and ``chip_smoke.py`` hold the kernels against. The table keeps
its logical width F; the kernels take any F.

There is no backward: the feature table is not trained.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphsage_tpu_torch.ops import build
from graphsage_tpu_torch.ops.philox import (
    check_stream,
    dropout_keep_mask,
    dropout_scale,
    dropout_threshold,
)

_KERNELS = {
    torch.float32: "graphsage_gather_mean_f32",
    torch.bfloat16: "graphsage_gather_mean_bf16",
}
_DROPOUT_KERNELS = {
    torch.float32: "graphsage_gather_mean_dropout_f32",
    torch.bfloat16: "graphsage_gather_mean_dropout_bf16",
}
# the row offsets of one output row sit in shared memory (8 bytes each)
# within the 48 KB a block gets without opting in
MAX_SAMPLES = 6144


def gather_mean_reference(features: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, F] float32 mean of features[idx] over S. The
    upcast happens on the gathered rows, never on the whole table."""
    B, S = idx.shape
    rows = features.index_select(0, idx.reshape(-1)).float()
    return rows.view(B, S, features.shape[1]).mean(dim=1)


def gather_mean_dropout_reference(features: torch.Tensor, idx: torch.Tensor,
                                  drop_rate: float, seed: int,
                                  offset: tuple[int, int]) -> torch.Tensor:
    """Plain version of K2: the f32 gathered rows, dropped per element by
    the Philox mask of ``ops/philox.py`` (counter words ``offset`` =
    (step, tag)) and scaled by 1/keep, then their mean over S."""
    B, S = idx.shape
    F = features.shape[1]
    rows = features.index_select(0, idx.reshape(-1)).float()
    keep = dropout_keep_mask(B * S, F, drop_rate, seed, *offset,
                             device=features.device)
    rows = torch.where(keep, rows * dropout_scale(drop_rate),
                       torch.zeros_like(rows))
    return rows.view(B, S, F).mean(dim=1)


def _check_inputs(features: torch.Tensor, idx: torch.Tensor) -> None:
    if features.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"features must be [N, F] and idx [B, S]; got "
            f"{tuple(features.shape)} and {tuple(idx.shape)}"
        )
    if features.dtype not in _KERNELS:
        raise TypeError(
            f"features must be float32 or bfloat16, got {features.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if features.device != idx.device:
        raise ValueError(
            f"features on {features.device} but idx on {idx.device}"
        )
    if not (features.is_contiguous() and idx.is_contiguous()):
        raise ValueError("features and idx must be contiguous")
    if not 1 <= idx.shape[1] <= MAX_SAMPLES:
        raise ValueError(
            f"samples per row must be in [1, {MAX_SAMPLES}], got "
            f"{idx.shape[1]}"
        )
    if idx.shape[0] >= 2**31:
        raise ValueError(f"too many rows for one launch: {idx.shape[0]}")


def _vector_width(F: int, elem_bytes: int, feat_ptr: int,
                  out_ptr: int) -> int:
    """Elements per load: the widest (at most 16 bytes) that divides F and
    keeps the table's and the f32 output's rows aligned, so that no row
    has a tail."""
    vec = 16 // elem_bytes
    while vec > 1 and (F % vec or feat_ptr % (vec * elem_bytes)
                       or out_ptr % (vec * 4)):
        vec //= 2
    return vec


_COMMON_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
]
_DROPOUT_ARGS = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                 ctypes.c_uint32, ctypes.c_float]


@functools.cache
def _kernel(dtype: torch.dtype, dropout: bool):
    lib = build.load("gather_mean")
    if dropout:
        fn = getattr(lib, _DROPOUT_KERNELS[dtype])
        fn.argtypes = _COMMON_ARGS + _DROPOUT_ARGS + [ctypes.c_void_p]
    else:
        fn = getattr(lib, _KERNELS[dtype])
        fn.argtypes = _COMMON_ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = build.load("gather_mean").graphsage_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def fused_gather_mean(features: torch.Tensor, idx: torch.Tensor,
                      drop_rate: float = 0.0, seed: int | None = None,
                      offset: tuple[int, int] | None = None) -> torch.Tensor:
    """[B, F] float32 = mean_s features[idx[b, s]], dropped out per
    element first when ``drop_rate > 0``.

    features: [N, F] float32 or bfloat16; idx: [B, S] int32, every entry
    in [0, N). Dropout needs ``seed`` (64-bit, the generator's key) and
    ``offset`` = (step, tag), the counter words that give each training
    step and each call site its own stream; all three are host integers,
    passed to the kernel by value. A CUDA tensor goes through K1 (no
    dropout; launches counted in ``fused_gather_mean.launches``) or K2
    (dropout; ``fused_gather_mean.dropout_launches``), one launch over
    all B, or raises; a CPU tensor goes through the plain version.
    """
    _check_inputs(features, idx)
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"drop_rate must be in [0, 1), got {drop_rate}")
    dropout = drop_rate > 0.0
    if dropout:
        if seed is None or offset is None:
            raise ValueError("drop_rate > 0 requires seed and offset")
        check_stream(seed, *offset)
    if features.device.type == "cpu":
        if dropout:
            return gather_mean_dropout_reference(features, idx, drop_rate,
                                                 seed, offset)
        return gather_mean_reference(features, idx)
    if features.device.type != "cuda":
        raise ValueError(
            f"fused_gather_mean runs on cuda or cpu, not {features.device}"
        )
    (B, S), (N, F) = idx.shape, features.shape
    out = torch.empty((B, F), dtype=torch.float32, device=features.device)
    if B == 0 or F == 0:
        return out
    fn = _kernel(features.dtype, dropout)
    vec = _vector_width(F, features.element_size(), features.data_ptr(),
                        out.data_ptr())
    args = [features.data_ptr(), idx.data_ptr(), out.data_ptr(), N, B, S, F,
            vec]
    if dropout:
        args += [seed, offset[0], offset[1], dropout_threshold(drop_rate),
                 dropout_scale(drop_rate)]
    with torch.cuda.device(features.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gather_mean kernel launch failed: CUDA error {err} "
            f"({_error_string(err)})"
        )
    if dropout:
        fused_gather_mean.dropout_launches += 1
    else:
        fused_gather_mean.launches += 1
    return out


fused_gather_mean.launches = 0           # K1
fused_gather_mean.dropout_launches = 0   # K2
