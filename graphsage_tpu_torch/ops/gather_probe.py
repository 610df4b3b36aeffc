"""The gather-mean probe's kernels (K7): other designs of the mean over S
sampled rows, ``out[b] = (1/S) * sum_s features[idx[b, s]]``, after the
JAX package's ``benchmarks/gather_probe.py``.

- ``probe_gather`` (K7a, ``wait`` = sample, row or tile): a ring of bulk
  row copies completing on mbarriers, waited for per sample, per output
  row or per tile (``_plain_kernel``, ``_bulkwait_kernel``,
  ``_tilewait_kernel``).
- ``probe_gather_hot`` (K7a, hot): ids below K read straight from the
  table under an L2 evict-last policy, the others by bulk copy
  (``_hot_kernel``).
- ``probe_coldsw`` (K7a, compacted): the sum of a row's first 4 x nb
  compacted cold ids over S (``_coldsw_kernel``).
- ``probe_hotcount`` (K7b): counts of the ids below K @ a bf16 hot block,
  over S, on the tensor cores (``_hotcount_kernel``).
- ``probe_hotmx`` (K7c): counts @ the table's first K rows in 2xTF32 on
  the tensor cores plus the compacted cold rows, over S
  (``_hotmx_kernel``).

The id compactions that the JAX probe runs in XLA outside its kernels
(``cold_first_stable`` for hotmx, ``cold_first_topk`` for coldsw/hc) are
plain torch here too, and the caller passes their result to the kernel.

The wrappers pick each launch's column slice and size its shared memory
(``ring_bytes``, ``hotmx_bytes``); the launch refuses a size that is not
``csrc/gather_probe.cu``'s layout, so the two cannot drift apart
unnoticed.

On a CUDA tensor each wrapper launches its kernel from
``csrc/gather_probe.cu`` (it never falls back) and counts the launch; on
a CPU tensor it runs the plain version below, which the tests and
``chip_smoke.py`` hold the kernels against. Shapes the kernels do not
take (a row pitch that is not a multiple of 16 bytes, a ring that fits
no column slice, B not a multiple of 128 for the counts kernel, a tile
that is not a multiple of the MMA's 16 rows) raise on either device. No
path of the package calls these: their entry point is
``graphsage_tpu_torch.benchmarks.gather_probe``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphsage_tpu_torch.ops import build
from graphsage_tpu_torch.ops.gather import (
    _DTYPES,
    _check_device,
    _raise_on_error,
    gather_mean_reference,
)

SOURCE = "gather_probe"
WAITS = ("sample", "row", "tile")
_WAIT_CODE = {"sample": 0, "row": 1, "tile": 2}
_MODE_CODE = {"plain": 0, "hot": 1, "compacted": 2}
TILE_B = 8                  # the JAX probe's rows a tile
SMEM_BYTES = 232_448        # a block's shared memory on the H100 (opt-in)
HOT_TILE = 128              # K7b's rows a block, the JAX HOT_TILE
MMA_ROWS = 16               # K7c's tile is a multiple of the MMA's M
MAX_COUNT = 256             # counts stay exact in bf16 up to S = 256
WARPS = 8                   # csrc/gather_probe.cu: 256 threads a block
MX_KC = 256                 # K7c's hot ids per warp and round


# ------------------------------------------------- the id compactions

def sample_width(S: int) -> int:
    """SW: a row's compacted slots, S rounded up to buckets of 4."""
    return -(-S // 4) * 4


def _compact(idx: torch.Tensor, idx_sorted: torch.Tensor, nc: torch.Tensor,
             N: int) -> torch.Tensor:
    """idx_sorted's first nc[b] ids of each row, then the dummy row N up
    to SW slots."""
    B, S = idx.shape
    pos = torch.arange(S, device=idx.device)[None, :]
    idx_dma = torch.where(pos < nc[:, None], idx_sorted, N)
    pad = sample_width(S) - S
    if pad:
        idx_dma = torch.cat([idx_dma, torch.full((B, pad), N,
                                                 dtype=idx.dtype,
                                                 device=idx.device)], dim=1)
    return idx_dma.to(torch.int32).contiguous()


def cold_first_stable(idx: torch.Tensor, K: int, N: int):
    """(idx_dma [B, SW] int32, nb [B] int32): each row's cold ids (>= K)
    compacted to the left in their order, the tail the dummy row N, and
    the buckets of 4 that hold them (JAX ``gather_probe.py:559-575``,
    kind hotmx)."""
    is_cold = idx >= K
    nc = is_cold.sum(dim=1, dtype=torch.int32)
    order = torch.sort((~is_cold).to(torch.int32), dim=1, stable=True).indices
    idx_dma = _compact(idx, torch.gather(idx, 1, order), nc, N)
    return idx_dma, ((nc + 3) // 4).to(torch.int32)


def cold_first_topk(idx: torch.Tensor, K: int, N: int):
    """(idx_dma [B, SW] int32, nb [B] int32, mask [B, SW] f32): each row's
    ids in descending order (the cold ones first), the slots past the
    cold count the dummy row N, the buckets of 4 and the live mask 1 for
    the slots below 4 x nb (JAX ``gather_probe.py:619-635``, kinds coldsw
    and hc)."""
    S = idx.shape[1]
    idx_sorted = torch.topk(idx, S, dim=1).values
    nc = (idx >= K).sum(dim=1, dtype=torch.int32)
    idx_dma = _compact(idx, idx_sorted, nc, N)
    nb = ((nc + 3) // 4).to(torch.int32)
    posw = torch.arange(idx_dma.shape[1], device=idx.device)[None, :]
    return idx_dma, nb, (posw < 4 * nb[:, None]).to(torch.float32)


def hot_counts(idx: torch.Tensor, K: int) -> torch.Tensor:
    """C [B, K] f32: how often each id below K occurs in each row."""
    B = idx.shape[0]
    counts = torch.zeros((B, K), dtype=torch.float32, device=idx.device)
    if K == 0:
        return counts
    hot = idx < K
    return counts.scatter_add_(1, torch.where(hot, idx, 0).long(),
                               hot.to(torch.float32))


# ------------------------------------------------------ plain versions

def coldsw_reference(features: torch.Tensor, idx_dma: torch.Tensor,
                     nb: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of K7a compacted: [B, F] f32, the sum of each row's
    first 4 x nb[b] slots of idx_dma (the rest selected away, never
    multiplied) times 1/S."""
    B, SW = idx_dma.shape
    rows = features.index_select(0, idx_dma.reshape(-1)).float()
    rows = rows.view(B, SW, features.shape[1])
    live = (torch.arange(SW, device=idx_dma.device)[None, :]
            < 4 * nb[:, None])
    rows = torch.where(live[:, :, None], rows, torch.zeros_like(rows))
    return rows.sum(dim=1) * (1.0 / S)


def hotcount_reference(idx: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """Plain version of K7b: (1/S) * C @ hot in f32, C the counts of the
    ids below K = hot.shape[0] (exact in hot's bf16 too)."""
    S = idx.shape[1]
    return (hot_counts(idx, hot.shape[0]) @ hot.float()) * (1.0 / S)


def hotmx_reference(features: torch.Tensor, idx: torch.Tensor,
                    idx_dma: torch.Tensor, nb: torch.Tensor,
                    K: int) -> torch.Tensor:
    """Plain version of K7c: (1/S) * (C @ features[:K] + the live slots
    of idx_dma, the stable cold-first compaction), in f32."""
    S = idx.shape[1]
    hot = hot_counts(idx, K) @ features[:K].float()
    return (hot + coldsw_reference(features, idx_dma, nb, 1)) * (1.0 / S)


# ------------------------------------------------------ shapes, checks

def bars_per_slot(wait: str, tile_b: int, W: int) -> int:
    return {"sample": tile_b * W, "row": tile_b, "tile": 1}[wait]


def ring_bytes(wait: str, n_buf: int, tile_b: int, W: int,
               slice_bytes: int) -> int:
    """K7a's shared memory: n_buf slots of tile_b x W column slices, the
    mbarriers, each slot's ids and live buckets, rounded up to 16 bytes
    (the layout of ``csrc/gather_probe.cu::make_ring``)."""
    slot_rows = tile_b * W
    n = (n_buf * slot_rows * slice_bytes
         + 8 * n_buf * bars_per_slot(wait, tile_b, W)
         + 4 * n_buf * slot_rows + 4 * n_buf * tile_b)
    return -(-n // 16) * 16


def mx_units(tile_b: int, FC: int) -> int:
    """K7c's units of 16 rows x 8 columns in a tile's slice."""
    return (tile_b // MMA_ROWS) * (FC // 8)


def hotmx_bytes(n_buf: int, tile_b: int, W: int, FC: int, S: int) -> int:
    """K7c's shared memory: K7a's row-wait ring, a round's counts, the
    warps' partial sums and the tile's ids (the layout of
    ``csrc/gather_probe.cu::probe_hotmx_kernel``)."""
    units = mx_units(tile_b, FC)
    parts = 1 if units >= WARPS else WARPS // units
    return (ring_bytes("row", n_buf, tile_b, W, 4 * FC)
            + 4 * tile_b * (parts * MX_KC + 4) + 4 * parts * tile_b * FC
            + 4 * tile_b * S)


def column_slice(F: int, elem: int, smem, multiple: int = 1,
                 max_units=None) -> int:
    """FC: the widest divisor of F whose slice is a multiple of 16 bytes
    (and of ``multiple`` columns) and whose shared memory ``smem(FC)``
    fits a block; ValueError where none does."""
    for FC in range(F, 0, -1):
        if F % FC or (FC * elem) % 16 or FC % multiple:
            continue
        if max_units is not None and max_units(FC) > WARPS:
            continue
        if smem(FC) <= SMEM_BYTES:
            return FC
    raise ValueError(
        f"no column slice of F = {F} ({elem}-byte elements) fits a block's "
        f"{SMEM_BYTES} bytes of shared memory; use a smaller tile_b or n_buf"
    )


@functools.cache
def _ring_slice(F: int, elem: int, wait: str, n_buf: int, tile_b: int,
                W: int) -> int:
    """K7a's column slice (cached: the wrappers ask at every call)."""
    return column_slice(F, elem, lambda fc: ring_bytes(
        wait, n_buf, tile_b, W, fc * elem))


@functools.cache
def _hotmx_slice(F: int, n_buf: int, tile_b: int, S: int) -> int:
    """K7c's column slice: a multiple of 8 f32 columns, at most 8 units."""
    return column_slice(
        F, 4, lambda fc: hotmx_bytes(n_buf, tile_b, sample_width(S), fc, S),
        multiple=8, max_units=lambda fc: mx_units(tile_b, fc))


def _check_table(features: torch.Tensor) -> None:
    if features.dim() != 2:
        raise ValueError(f"features must be [N+1, F], got "
                         f"{tuple(features.shape)}")
    if features.dtype not in _DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got "
                        f"{features.dtype}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous")
    pitch = features.shape[1] * features.element_size()
    if pitch % 16:
        raise ValueError(
            f"a bulk row copy needs a row pitch that is a multiple of 16 "
            f"bytes; the table's rows are {pitch} bytes ({features.shape[1]}"
            f" x {features.dtype})"
        )


def _check_ids(idx: torch.Tensor, features_or_hot: torch.Tensor,
               what: str = "idx") -> None:
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise TypeError(f"{what} must be [B, S] int32, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if idx.device != features_or_hot.device:
        raise ValueError(f"{what} on {idx.device} but the table on "
                         f"{features_or_hot.device}")
    if idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError(f"{what} must have rows and samples, got "
                         f"{tuple(idx.shape)}")


def _check_compacted(idx_dma: torch.Tensor, nb: torch.Tensor,
                     features: torch.Tensor) -> None:
    _check_ids(idx_dma, features, "idx_dma")
    B, SW = idx_dma.shape
    if SW % 4:
        raise ValueError(f"idx_dma's width must be a multiple of 4, got {SW}")
    if (nb.shape != (B,) or nb.dtype != torch.int32 or not nb.is_contiguous()
            or nb.device != features.device):
        raise ValueError(f"nb must be [{B}] int32, contiguous, on "
                         f"{features.device}")


def _check_ring(tile_b: int, n_buf: int) -> None:
    if tile_b < 1 or n_buf < 1:
        raise ValueError(f"tile_b and n_buf must be >= 1, got {tile_b}, "
                         f"{n_buf}")


_GATHER_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p])
_HOTCOUNT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_HOTMX_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
               + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p])


@functools.cache
def _fn(symbol: str, argtypes: tuple):
    fn = getattr(build.load(SOURCE), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_aligned(*tensors: torch.Tensor) -> None:
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("bulk copies need 16-byte aligned tensors")


def _launch_ring(features, idx, nb, W, S, FC, tile_b, n_buf, K, wait, mode):
    B, F = idx.shape[0], features.shape[1]
    out = torch.empty((B, F), dtype=torch.float32, device=features.device)
    _check_aligned(features, out)
    fn = _fn(f"graphsage_probe_gather_{_DTYPES[features.dtype]}",
             tuple(_GATHER_ARGS))
    smem = ring_bytes(wait, n_buf, tile_b, W, FC * features.element_size())
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), idx.data_ptr(),
                 None if nb is None else nb.data_ptr(), out.data_ptr(),
                 features.shape[0], B, W, S, F, FC, tile_b, n_buf, K,
                 _WAIT_CODE[wait], _MODE_CODE[mode], smem, _stream())
    _raise_on_error(err, SOURCE)
    return out


# ------------------------------------------------------------- wrappers

def probe_gather(features: torch.Tensor, idx: torch.Tensor,
                 wait: str = "sample", tile_b: int = TILE_B,
                 n_buf: int = 2) -> torch.Tensor:
    """[B, F] f32 mean of features[idx] over S, through K7a's ring of
    ``n_buf`` slots of ``tile_b`` rows, waited for per ``wait`` (sample,
    row or tile). features [N+1, F] f32 or bf16, idx [B, S] int32 in
    [0, N+1). Launches counted in ``probe_gather.launches[wait]``."""
    _check_table(features)
    _check_ids(idx, features)
    _check_ring(tile_b, n_buf)
    if wait not in WAITS:
        raise ValueError(f"wait must be one of {WAITS}, got {wait!r}")
    S, (_, F), elem = idx.shape[1], features.shape, features.element_size()
    FC = _ring_slice(F, elem, wait, n_buf, tile_b, S)
    if features.device.type == "cpu":
        return gather_mean_reference(features, idx)
    _check_device(features, "probe_gather")
    out = _launch_ring(features, idx, None, S, S, FC, tile_b, n_buf, 0,
                       wait, "plain")
    probe_gather.launches[wait] += 1
    return out


probe_gather.launches = dict.fromkeys(WAITS, 0)   # K7a plain/bulk/tilewait


def probe_gather_hot(features: torch.Tensor, idx: torch.Tensor, K: int,
                     tile_b: int = TILE_B, n_buf: int = 2) -> torch.Tensor:
    """As ``probe_gather`` with per-sample waits, the ids below K read
    straight from the table (K7a hot; ``probe_gather_hot.launches``)."""
    _check_table(features)
    _check_ids(idx, features)
    _check_ring(tile_b, n_buf)
    if not 0 <= K < 2**31:
        raise ValueError(f"K must be in [0, 2**31), got {K}")
    S, (_, F), elem = idx.shape[1], features.shape, features.element_size()
    FC = _ring_slice(F, elem, "sample", n_buf, tile_b, S)
    if features.device.type == "cpu":
        return gather_mean_reference(features, idx)
    _check_device(features, "probe_gather_hot")
    out = _launch_ring(features, idx, None, S, S, FC, tile_b, n_buf, K,
                       "sample", "hot")
    probe_gather_hot.launches += 1
    return out


probe_gather_hot.launches = 0


def probe_coldsw(features: torch.Tensor, idx_dma: torch.Tensor,
                 nb: torch.Tensor, S: int, tile_b: int = TILE_B,
                 n_buf: int = 2) -> torch.Tensor:
    """[B, F] f32: (1/S) x the sum of each row's first 4 x nb[b] slots of
    idx_dma [B, SW] (SW a multiple of 4, nb [B] int32 in [0, SW/4]),
    through K7a's ring with one wait per row (K7a compacted;
    ``probe_coldsw.launches``)."""
    _check_table(features)
    _check_compacted(idx_dma, nb, features)
    _check_ring(tile_b, n_buf)
    SW = idx_dma.shape[1]
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    F, elem = features.shape[1], features.element_size()
    FC = _ring_slice(F, elem, "row", n_buf, tile_b, SW)
    if features.device.type == "cpu":
        return coldsw_reference(features, idx_dma, nb, S)
    _check_device(features, "probe_coldsw")
    out = _launch_ring(features, idx_dma, nb, SW, S, FC, tile_b, n_buf, 0,
                       "row", "compacted")
    probe_coldsw.launches += 1
    return out


probe_coldsw.launches = 0


def probe_hotcount(idx: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """[B, F] f32 = (1/S) x C @ hot, C the counts of the ids below K in
    each row, hot [K, F] bf16, B a multiple of 128 (K7b;
    ``probe_hotcount.launches``)."""
    if hot.dim() != 2 or hot.dtype != torch.bfloat16:
        raise TypeError(f"hot must be [K, F] bfloat16, got "
                        f"{tuple(hot.shape)} {hot.dtype}")
    if not hot.is_contiguous():
        raise ValueError("hot must be contiguous")
    _check_ids(idx, hot)
    B, S = idx.shape
    if B % HOT_TILE:
        raise ValueError(f"B must be a multiple of {HOT_TILE} (the counts "
                         f"kernel's tile, as the JAX grid B // {HOT_TILE}); "
                         f"got {B}")
    if S > MAX_COUNT:
        raise ValueError(f"S must be at most {MAX_COUNT} (counts exact in "
                         f"bf16), got {S}")
    if hot.device.type == "cpu":
        return hotcount_reference(idx, hot)
    _check_device(hot, "probe_hotcount")
    K, F = hot.shape
    out = torch.empty((B, F), dtype=torch.float32, device=hot.device)
    fn = _fn("graphsage_probe_hotcount", tuple(_HOTCOUNT_ARGS))
    with torch.cuda.device(hot.device):
        err = fn(idx.data_ptr(), hot.data_ptr(), out.data_ptr(), B, S, F, K,
                 _stream())
    _raise_on_error(err, SOURCE)
    probe_hotcount.launches += 1
    return out


probe_hotcount.launches = 0


def probe_hotmx(features: torch.Tensor, idx: torch.Tensor,
                idx_dma: torch.Tensor, nb: torch.Tensor, K: int,
                tile_b: int = MMA_ROWS, n_buf: int = 2) -> torch.Tensor:
    """[B, F] f32 = (1/S) x (C @ features[:K] + the row's cold samples),
    the hot part in 2xTF32 on the tensor cores while the cold rows
    arrive through K7a's ring (K7c; ``probe_hotmx.launches``). idx_dma
    and nb are ``cold_first_stable(idx, K, N)``; features f32, K <= its
    rows, tile_b a multiple of 16."""
    _check_table(features)
    if features.dtype != torch.float32:
        raise TypeError(f"hotmx takes an f32 table, got {features.dtype}")
    _check_ids(idx, features)
    _check_ring(tile_b, n_buf)
    if tile_b % MMA_ROWS:
        raise ValueError(f"tile_b must be a multiple of {MMA_ROWS} (the "
                         f"MMA's rows), got {tile_b}")
    if not 0 <= K <= features.shape[0]:
        raise ValueError(f"K must be in [0, {features.shape[0]}], got {K}")
    B, S = idx.shape
    SW, F = sample_width(S), features.shape[1]
    _check_compacted(idx_dma, nb, features)
    if idx_dma.shape != (B, SW):
        raise ValueError(f"idx_dma must be [{B}, {SW}] for idx [{B}, {S}], "
                         f"got {tuple(idx_dma.shape)}")
    FC = _hotmx_slice(F, n_buf, tile_b, S)
    if features.device.type == "cpu":
        return hotmx_reference(features, idx, idx_dma, nb, K)
    _check_device(features, "probe_hotmx")
    out = torch.empty((B, F), dtype=torch.float32, device=features.device)
    _check_aligned(features, out)
    fn = _fn("graphsage_probe_hotmx", tuple(_HOTMX_ARGS))
    smem = hotmx_bytes(n_buf, tile_b, SW, FC, S)
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), idx.data_ptr(), idx_dma.data_ptr(),
                 nb.data_ptr(), out.data_ptr(), features.shape[0], B, S, SW,
                 F, FC, tile_b, n_buf, K, smem, _stream())
    _raise_on_error(err, SOURCE)
    probe_hotmx.launches += 1
    return out


probe_hotmx.launches = 0
