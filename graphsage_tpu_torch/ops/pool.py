"""Fused gather -> per-neighbor MLP -> max/mean pool, with a training path.

The pooling aggregators run a Dense layer with relu on every sampled
neighbor and reduce over the fanout. For the innermost hop this module
does it in one kernel:

  out[b, :] = reduce_s relu(X[b*S + s, :] @ w + bias)
  X         = features[idx.reshape(-1)] in f32, dropped per element by
              the Philox mask of ``ops/philox.py`` when ``drop_rate > 0``

- ``fused_gather_mlp_pool``: forward only. On a CUDA tensor it launches
  K5 (``csrc/gather_mlp_pool.cu``), which writes nothing but the [B, H]
  result; launches counted in ``fused_gather_mlp_pool.launches``.
- ``gather_mlp_pool_train``: differentiable in ``w`` and ``b``. When a
  gradient is wanted, its forward launches K6, the same kernel writing
  the dropped rows X [B*S, F] f32 as the backward's residual (counted in
  ``fused_gather_mlp_pool.train_launches``); the backward,
  ``route_pool_grad``, is plain tensor code from X and never gathers
  again. Without a gradient (e.g. under ``torch.inference_mode()``) it
  launches K5, as the JAX package's primal body skips the residual.
  ``features`` and ``idx`` get no gradient: the feature table is not
  trained.

K5/K6 run the product on the tensor cores in 3xTF32 (``tf32_split``
states the split), f32-accurate as the plain versions' f32 product.

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
versions below, which the tests and ``chip_smoke.py`` hold the kernels
against. The table keeps its logical width F; the kernel takes any F
and H. The mask's element order is K2's: row r = b*S + s of the gathered
rows, so the same (seed, step, tag) drops the same elements in both.
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

REDUCES = ("mean", "max")
_KERNELS = {
    torch.float32: "graphsage_gather_mlp_pool_f32",
    torch.bfloat16: "graphsage_gather_mlp_pool_bf16",
}


# ------------------------------------------------------ plain versions

def gathered_rows_reference(features: torch.Tensor, idx: torch.Tensor,
                            drop_rate: float = 0.0, seed: int | None = None,
                            offset: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """Plain version of K6's residual: the [B*S, F] f32 gathered rows,
    dropped by the Philox mask (counter words ``offset`` = (step, tag))
    and scaled by 1/keep when ``drop_rate > 0``."""
    B, S = idx.shape
    rows = features.index_select(0, idx.reshape(-1)).float()
    if drop_rate > 0.0:
        keep = dropout_keep_mask(B * S, features.shape[1], drop_rate, seed,
                                 *offset, device=features.device)
        rows = torch.where(keep, rows * dropout_scale(drop_rate),
                           torch.zeros_like(rows))
    return rows


def pool_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              reduce: str, S: int) -> torch.Tensor:
    """[B, H] = reduce_s relu(x @ w + b) over groups of S rows of x."""
    h = torch.relu(x @ w + b).view(-1, S, w.shape[1])
    return torch.amax(h, dim=1) if reduce == "max" else h.mean(dim=1)


def gather_mlp_pool_reference(features, idx, w, b, reduce: str = "max",
                              drop_rate: float = 0.0, seed=None,
                              offset=None):
    """Plain version of K5: reduce_s relu(X @ w + b) for the f32 rows X
    of ``gathered_rows_reference`` (dropped when ``drop_rate > 0``)."""
    return pool_rows(
        gathered_rows_reference(features, idx, drop_rate, seed, offset),
        w, b, reduce, idx.shape[1])


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of x in f32 with hi = tf32(x) and lo = tf32(x - hi), each
    rounded as the kernel's ``cvt.rna.tf32.f32`` rounds: to nearest, ties
    away from zero (add 0x1000 to the bit pattern, clear its low 13
    bits). hi + lo keeps ~21 of x's 24 significant bits. K5/K6 sum
    hi*hi + hi*lo + lo*hi (3xTF32) of their operands on the tensor cores;
    this documents that arithmetic and no path calls it."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def route_pool_grad(dy, x, w, b, reduce: str, S: int):
    """(grad_w, grad_b) of reduce_s relu(x @ w + b) from the saved rows x
    [B*S, F], as the JAX package's ``_route_pool_grad``: relu' is zero
    at z <= 0 and the max's gradient splits evenly among ties. The tie
    mask compares against a max recomputed from the same z, never the
    forward's output, whose kernel sums in another order."""
    B, H = dy.shape
    z = x @ w + b
    if reduce == "max":
        h = torch.relu(z).view(B, S, H)
        m = (h == torch.amax(h, dim=1, keepdim=True)).float()
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        dh = (dy[:, None, :] * m / cnt).reshape(B * S, H)
    else:
        dh = (dy[:, None, :] / S).expand(B, S, H).reshape(B * S, H)
    dz = torch.where(z > 0, dh, torch.zeros_like(dh))
    return x.t() @ dz, dz.sum(dim=0)


# -------------------------------------------------------------- kernels

def _check_inputs(features, idx, w, b, reduce, drop_rate, seed, offset):
    if features.dim() != 2 or idx.dim() != 2:
        raise ValueError(
            f"features must be [N, F] and idx [B, S]; got "
            f"{tuple(features.shape)} and {tuple(idx.shape)}"
        )
    F = features.shape[1]
    if w.dim() != 2 or w.shape[0] != F or b.shape != (w.shape[1],):
        raise ValueError(
            f"w must be [F={F}, H] and b [H]; got {tuple(w.shape)} and "
            f"{tuple(b.shape)}"
        )
    if features.dtype not in _KERNELS:
        raise TypeError(
            f"features must be float32 or bfloat16, got {features.dtype}"
        )
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if w.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"w and b must be float32, got {w.dtype}, {b.dtype}")
    if len({t.device for t in (features, idx, w, b)}) != 1:
        raise ValueError("features, idx, w and b must be on one device")
    if not all(t.is_contiguous() for t in (features, idx, w, b)):
        raise ValueError("features, idx, w and b must be contiguous")
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")
    if idx.shape[1] < 1 or F < 1 or w.shape[1] < 1:
        raise ValueError("S, F and H must be at least 1")
    if idx.numel() >= 2**31:
        raise ValueError(f"too many rows for one launch: {idx.numel()}")
    if not 0.0 <= drop_rate < 1.0:
        raise ValueError(f"drop_rate must be in [0, 1), got {drop_rate}")
    if drop_rate > 0.0:
        if seed is None or offset is None:
            raise ValueError("drop_rate > 0 requires seed and offset")
        check_stream(seed, *offset)


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(build.load("gather_mlp_pool"), _KERNELS[dtype])
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
           ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = build.load("gather_mlp_pool").graphsage_pool_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


@functools.cache
def _wt_floats(F: int, H: int) -> int:
    """Floats of the kernel's scratch for w's TF32 split."""
    fn = build.load("gather_mlp_pool").graphsage_gather_mlp_pool_wt_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(F, H)


def _launch(features, idx, w, b, reduce, drop_rate, seed, offset,
            want_x: bool):
    """One launch of the kernel on a CUDA tensor -> (out [B, H], x
    [B*S, F] or None)."""
    if features.device.type != "cuda":
        raise ValueError(
            f"the gather-MLP-pool kernel runs on cuda, not {features.device}"
        )
    (B, S), (N, F), H = idx.shape, features.shape, w.shape[1]
    out = torch.empty((B, H), dtype=torch.float32, device=features.device)
    x = (torch.empty((B * S, F), dtype=torch.float32,
                     device=features.device) if want_x else None)
    if B == 0:
        return out, x
    wt = torch.empty(_wt_floats(F, H), dtype=torch.float32,
                     device=features.device)
    dropout = drop_rate > 0.0
    args = [features.data_ptr(), idx.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), x.data_ptr() if want_x else None, wt.data_ptr(),
            N, B, S, F, H,
            int(reduce == "max"), int(dropout), int(want_x),
            seed if dropout else 0, offset[0] if dropout else 0,
            offset[1] if dropout else 0,
            dropout_threshold(drop_rate) if dropout else 0,
            dropout_scale(drop_rate) if dropout else 1.0]
    with torch.cuda.device(features.device):
        err = _kernel(features.dtype)(*args,
                                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"gather_mlp_pool kernel launch failed: CUDA error {err} "
            f"({_error_string(err)})"
        )
    return out, x


def fused_gather_mlp_pool(features: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          reduce: str = "max", drop_rate: float = 0.0,
                          seed: int | None = None,
                          offset: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """[B, H] f32 = reduce_s relu(features[idx[b, s]] @ w + b), forward
    only (K5 on a CUDA tensor, one launch over all B).

    features: [N, F] float32 or bfloat16; idx: [B, S] int32, every entry
    in [0, N); w: [F, H] and b: [H] float32; reduce "mean" or "max".
    Dropout on the MLP's input rows needs ``seed`` (64-bit) and
    ``offset`` = (step, tag), host integers passed by value, as in
    ``fused_gather_mean``.
    """
    _check_inputs(features, idx, w, b, reduce, drop_rate, seed, offset)
    if features.device.type == "cpu":
        return gather_mlp_pool_reference(features, idx, w, b, reduce,
                                         drop_rate, seed, offset)
    out, _ = _launch(features, idx, w, b, reduce, drop_rate, seed, offset,
                     want_x=False)
    fused_gather_mlp_pool.launches += 1
    return out


def gather_mlp_pool_with_rows(features, idx, w, b, reduce: str = "max",
                              drop_rate: float = 0.0, seed=None, offset=None):
    """K6's forward -> (pooled [B, H], x [B*S, F] f32): the pooled
    output and the dropped gathered rows it was computed from."""
    _check_inputs(features, idx, w, b, reduce, drop_rate, seed, offset)
    if features.device.type == "cpu":
        x = gathered_rows_reference(features, idx, drop_rate, seed, offset)
        return pool_rows(x, w, b, reduce, idx.shape[1]), x
    out, x = _launch(features, idx, w, b, reduce, drop_rate, seed, offset,
                     want_x=True)
    fused_gather_mlp_pool.train_launches += 1
    return out, x


fused_gather_mlp_pool.launches = 0        # K5
fused_gather_mlp_pool.train_launches = 0  # K6


class _GatherMLPPool(torch.autograd.Function):
    """K6 forward, ``route_pool_grad`` backward."""

    @staticmethod
    def forward(ctx, features, idx, w, b, reduce, drop_rate, seed, offset):
        pooled, x = gather_mlp_pool_with_rows(features, idx, w, b, reduce,
                                              drop_rate, seed, offset)
        ctx.save_for_backward(x, w, b)
        ctx.reduce, ctx.S = reduce, idx.shape[1]
        return pooled

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        grad_w, grad_b = route_pool_grad(dy, x, w, b, ctx.reduce, ctx.S)
        return None, None, grad_w, grad_b, None, None, None, None


def gather_mlp_pool_train(features: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor,
                          reduce: str = "max", drop_rate: float = 0.0,
                          seed: int | None = None,
                          offset: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """``fused_gather_mlp_pool`` with gradients for ``w`` and ``b``: K6
    and its residual when autograd will want them, K5 otherwise. The
    gradients are exact for the realised dropout mask."""
    if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
        return _GatherMLPPool.apply(features, idx, w, b, reduce, drop_rate,
                                    seed, offset)
    return fused_gather_mlp_pool(features, idx, w, b, reduce, drop_rate,
                                 seed, offset)
