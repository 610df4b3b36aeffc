"""Fused embedding-gather + neighbor mean (with optional dropout or
deduplication), and the plain row gather.

``fused_gather_mean`` computes ``features[idx].view(B, S, F).mean(1)``
without writing the [B*S, F] gather to memory. With ``drop_rate > 0``
each gathered element is first dropped or scaled by 1/keep, by a mask
drawn from Philox4x32-10 (``ops/philox.py`` defines the bits), and
neither the rows nor the mask reach memory either. With ``dedup`` (and
no dropout) each distinct sample of a row is loaded once and weighted by
its multiplicity/S.

``fused_gather_rows`` computes ``features[idx.reshape(-1)]``, the
[B*S, F] rows in the table's dtype, for the consumers that need the
individual rows (the pooling MLPs, the LSTM sequence).

On a CUDA tensor each launches a hand-written kernel (it never falls
back): K1 (``csrc/gather_mean.cu``, no dropout), K2 (the same source,
dropout), K3 (the same source, dedup) and K4 (``csrc/gather_rows.cu``).
On a CPU tensor each runs its plain PyTorch version below, which the
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
    check_block,
    check_stream,
    dropout_keep_mask,
    dropout_scale,
    dropout_threshold,
)

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (source, C symbol prefix) of each variant; the symbol ends in the dtype
_VARIANTS = {
    "mean": ("gather_mean", "graphsage_gather_mean"),                  # K1
    "dropout": ("gather_mean", "graphsage_gather_mean_dropout"),       # K2
    "dedup": ("gather_mean", "graphsage_gather_mean_dedup"),           # K3
}
# K1/K2 keep one output row's S row offsets in shared memory (8 bytes
# each) within the 48 KB a block gets without opting in
MAX_SAMPLES = 6144
# K3 keeps 20 bytes a sample there (the samples, first-occurrence flags,
# the distinct rows' offsets and weights): 60 KB at this limit, which
# the launch opts into
MAX_DEDUP_SAMPLES = 3072


# ------------------------------------------------------ plain versions

def gather_mean_reference(features: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, F] float32 mean of features[idx] over S. The
    upcast happens on the gathered rows, never on the whole table."""
    B, S = idx.shape
    rows = features.index_select(0, idx.reshape(-1)).float()
    return rows.view(B, S, features.shape[1]).mean(dim=1)


def gather_mean_dropout_reference(features: torch.Tensor, idx: torch.Tensor,
                                  drop_rate: float, seed: int,
                                  offset: tuple[int, int], col_base: int = 0,
                                  row_width: int | None = None
                                  ) -> torch.Tensor:
    """Plain version of K2: the f32 gathered rows, dropped per element by
    the Philox mask of ``ops/philox.py`` (counter words ``offset`` =
    (step, tag); a table that holds columns ``col_base ..`` of rows
    ``row_width`` wide takes those columns of the whole rows' mask) and
    scaled by 1/keep, then their mean over S."""
    B, S = idx.shape
    F = features.shape[1]
    rows = features.index_select(0, idx.reshape(-1)).float()
    keep = dropout_keep_mask(B * S, F, drop_rate, seed, *offset,
                             device=features.device, col_base=col_base,
                             row_width=row_width)
    rows = torch.where(keep, rows * dropout_scale(drop_rate),
                       torch.zeros_like(rows))
    return rows.view(B, S, F).mean(dim=1)


def dedup_compact(idx: torch.Tensor):
    """(idx_unique [B, S], n_unique [B] int32, w [B, S] f32) of each row
    of ``idx`` [B, S]: its distinct values in ascending order compacted
    to the left (the tail is 0), their count, and multiplicity/S at the
    compacted positions (0 in the tail). O(B*S^2) compares, as the JAX
    package's ``dedup_compact``."""
    B, S = idx.shape
    idx_sorted = torch.sort(idx, dim=1).values
    counts = (idx_sorted[:, :, None] == idx_sorted[:, None, :]).sum(-1)
    first = torch.cat([
        torch.ones_like(idx_sorted[:, :1], dtype=torch.bool),
        idx_sorted[:, 1:] != idx_sorted[:, :-1],
    ], dim=1)
    pos = torch.cumsum(first, dim=1) - 1          # compacted position
    n_unique = (pos[:, -1] + 1).to(torch.int32)
    # a run of equal values scatters the same value to one position
    idx_unique = torch.zeros_like(idx_sorted).scatter_(1, pos, idx_sorted)
    w = torch.zeros((B, S), dtype=torch.float32, device=idx.device)
    w.scatter_add_(1, pos, torch.where(first, counts.float() / S,
                                       torch.zeros_like(w)))
    return idx_unique, n_unique, w


def gather_mean_dedup_reference(features: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``dedup_compact``, then the f32 sum of w *
    row over the first n_unique positions (the tail selected to zero
    first, as the JAX kernel does). Equal to the mean over S up to f32
    rounding."""
    B, S = idx.shape
    idx_u, _, w = dedup_compact(idx)
    rows = features.index_select(0, idx_u.reshape(-1)).float()
    rows = rows.view(B, S, features.shape[1])
    wb = w[:, :, None]
    rows = torch.where(wb > 0, rows, torch.zeros_like(rows))
    return (rows * wb).sum(dim=1)


def gather_rows_reference(features: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: [B*S, F] = features[idx.reshape(-1)], in the
    table's dtype."""
    return features.index_select(0, idx.reshape(-1))


# -------------------------------------------------------------- kernels

def _check_inputs(features: torch.Tensor, idx: torch.Tensor,
                  max_samples: int = MAX_SAMPLES) -> None:
    if features.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"features must be [N, F] and idx [B, S]; got "
            f"{tuple(features.shape)} and {tuple(idx.shape)}"
        )
    if features.dtype not in _DTYPES:
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
    if not 1 <= idx.shape[1] <= max_samples:
        raise ValueError(
            f"samples per row must be in [1, {max_samples}], got "
            f"{idx.shape[1]}"
        )
    if idx.shape[0] >= 2**31:
        raise ValueError(f"too many rows for one launch: {idx.shape[0]}")


def _check_device(features: torch.Tensor, what: str) -> None:
    if features.device.type != "cuda":
        raise ValueError(
            f"{what} runs on cuda or cpu, not {features.device}"
        )


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


def _copy_width(row_bytes: int, feat_ptr: int, out_ptr: int) -> int:
    """Bytes per access of the row copy: the widest of 16, 8, 4 and 2
    that divides the row's bytes and both rows' start addresses."""
    unit = 16
    while unit > 2 and (row_bytes % unit or feat_ptr % unit
                        or out_ptr % unit):
        unit //= 2
    return unit


_COMMON_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
]
_DROPOUT_ARGS = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                 ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                 ctypes.c_longlong]
_ROWS_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


@functools.cache
def _kernel(dtype: torch.dtype, variant: str):
    source, prefix = _VARIANTS[variant]
    fn = getattr(build.load(source), f"{prefix}_{_DTYPES[dtype]}")
    extra = _DROPOUT_ARGS if variant == "dropout" else []
    fn.argtypes = _COMMON_ARGS + extra + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _rows_kernel():
    fn = build.load("gather_rows").graphsage_gather_rows
    fn.argtypes = _ROWS_ARGS
    fn.restype = ctypes.c_int
    return fn


def _raise_on_error(err: int, source: str) -> None:
    if err == 0:
        return
    fn = build.load(source).graphsage_cuda_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(
        f"{source} kernel launch failed: CUDA error {err} "
        f"({fn(err).decode()})"
    )


def fused_gather_mean(features: torch.Tensor, idx: torch.Tensor,
                      drop_rate: float = 0.0, seed: int | None = None,
                      offset: tuple[int, int] | None = None,
                      dedup: bool = False, col_base: int = 0,
                      row_width: int | None = None) -> torch.Tensor:
    """[B, F] float32 = mean_s features[idx[b, s]], dropped out per
    element first when ``drop_rate > 0``.

    features: [N, F] float32 or bfloat16; idx: [B, S] int32, every entry
    in [0, N). Dropout needs ``seed`` (64-bit, the generator's key) and
    ``offset`` = (step, tag), the counter words that give each training
    step and each call site its own stream; all three are host integers,
    passed to the kernel by value. ``dedup`` loads each distinct sample
    of a row once and weights it by multiplicity/S (S at most
    ``MAX_DEDUP_SAMPLES``). With ``drop_rate > 0`` it is ignored and K2
    runs: each duplicate draws its own mask, which a weighted distinct
    row cannot express (the JAX package's rule).

    A CUDA tensor goes through K1 (launches counted in
    ``fused_gather_mean.launches``), K2 (dropout;
    ``fused_gather_mean.dropout_launches``) or K3 (dedup;
    ``fused_gather_mean.dedup_launches``), one launch over all B, or
    raises; a CPU tensor goes through the plain version.

    A table that is a column block, columns ``col_base ..`` of rows
    ``row_width`` wide (a rank's block under tensor parallelism,
    ``parallel/tensor.py``), gives the matching columns of the whole
    table's result: the mean is per column, and K2 draws each element's
    bits at its column in the whole row (``ops/philox.py``).
    """
    dropout = drop_rate > 0.0
    variant = "dropout" if dropout else ("dedup" if dedup else "mean")
    _check_inputs(features, idx, MAX_DEDUP_SAMPLES if variant == "dedup"
                  else MAX_SAMPLES)
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"drop_rate must be in [0, 1), got {drop_rate}")
    if dropout:
        if seed is None or offset is None:
            raise ValueError("drop_rate > 0 requires seed and offset")
        check_stream(seed, *offset)
    row_width = check_block(features.shape[1], col_base, row_width)
    if features.device.type == "cpu":
        if dropout:
            return gather_mean_dropout_reference(features, idx, drop_rate,
                                                 seed, offset, col_base,
                                                 row_width)
        if dedup:
            return gather_mean_dedup_reference(features, idx)
        return gather_mean_reference(features, idx)
    _check_device(features, "fused_gather_mean")
    (B, S), (N, F) = idx.shape, features.shape
    out = torch.empty((B, F), dtype=torch.float32, device=features.device)
    if B == 0 or F == 0:
        return out
    fn = _kernel(features.dtype, variant)
    vec = _vector_width(F, features.element_size(), features.data_ptr(),
                        out.data_ptr())
    args = [features.data_ptr(), idx.data_ptr(), out.data_ptr(), N, B, S, F,
            vec]
    if dropout:
        args += [seed, offset[0], offset[1], dropout_threshold(drop_rate),
                 dropout_scale(drop_rate), col_base, -(-row_width // 4)]
    with torch.cuda.device(features.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "gather_mean")
    if variant == "dropout":
        fused_gather_mean.dropout_launches += 1
    elif variant == "dedup":
        fused_gather_mean.dedup_launches += 1
    else:
        fused_gather_mean.launches += 1
    return out


fused_gather_mean.launches = 0           # K1
fused_gather_mean.dropout_launches = 0   # K2
fused_gather_mean.dedup_launches = 0     # K3


def fused_gather_rows(features: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """[B*S, F] = features[idx.reshape(-1)], in the table's dtype.

    The inputs are checked as ``fused_gather_mean`` checks them (S is
    bounded only by the row count). A CUDA tensor goes through K4, one
    launch over all B*S rows (counted in ``fused_gather_rows.launches``),
    or raises; a CPU tensor goes through ``gather_rows_reference``.
    """
    _check_inputs(features, idx, max_samples=2**31 - 1)
    if features.device.type == "cpu":
        return gather_rows_reference(features, idx)
    _check_device(features, "fused_gather_rows")
    (B, S), (N, F) = idx.shape, features.shape
    out = torch.empty((B * S, F), dtype=features.dtype,
                      device=features.device)
    if B == 0 or F == 0:
        return out
    row_bytes = F * features.element_size()
    unit = _copy_width(row_bytes, features.data_ptr(), out.data_ptr())
    with torch.cuda.device(features.device):
        err = _rows_kernel()(features.data_ptr(), idx.data_ptr(),
                             out.data_ptr(), N, B * S, row_bytes, unit,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "gather_rows")
    fused_gather_rows.launches += 1
    return out


fused_gather_rows.launches = 0           # K4
