"""The gather-mean probe's kernels (K7): other designs of the mean over S
sampled rows, ``out[b] = (1/S) * sum_s features[idx[b, s]]``, after the
JAX package's ``benchmarks/gather_probe.py``.

- ``probe_gather`` (K7a, ``wait`` = sample, row or tile): producer
  warps' bulk row copies into a ring of stages in shared memory,
  completing on mbarriers that consumer warps wait on per sample, per
  output row or per stage (``_plain_kernel``, ``_bulkwait_kernel``,
  ``_tilewait_kernel``).
- ``probe_gather_hot`` (K7a, hot): ids below K read straight from the
  table under an L2 evict-last policy, the others by bulk copy
  (``_hot_kernel``).
- ``probe_coldsw`` (K7a, compacted): the sum of a row's first 4 x nb
  compacted cold ids over S (``_coldsw_kernel``).
- ``probe_hotcount`` (K7b): counts of the ids below K @ a bf16 hot block,
  over S, on the tensor cores (``_hotcount_kernel``): tiles of 64 rows x
  64 columns, each row's hot ids sorted once and written into a window
  of counts by the thread that owns the row, the hot block staged by TMA
  into a ring and read by ``wgmma`` as it landed.
- ``probe_hotmx`` (K7c): the whole mean, counts @ the table's first K
  rows in 2xTF32 on the tensor cores (``wgmma``, the hot rows by TMA)
  plus the row's cold samples (id >= K) summed by other warps straight
  from the table, over S (``_hotmx_kernel`` with the stable cold-first
  compaction the JAX probe runs before it: the kernel reads the raw ids
  and needs no compaction).

The top_k compaction that the JAX probe runs in XLA before coldsw/hc
(``cold_first_topk``) is plain torch here too, and the caller passes its
result to the kernel; ``cold_first_stable`` restates the one before the
JAX hotmx kernel.

The wrappers pick each launch's column slice and size its shared memory
(``ring_bytes``, ``hotcount_bytes``, ``hotmx_bytes``); the launch refuses
a size that is not ``csrc/gather_probe.cu``'s layout, so the two cannot
drift apart unnoticed.

On a CUDA tensor each wrapper launches its kernel from
``csrc/gather_probe.cu`` (it never falls back) and counts the launch; on
a CPU tensor it runs the plain version below, which the tests and
``chip_smoke.py`` hold the kernels against. Shapes the kernels do not
take (a row pitch that is not a multiple of 16 bytes, a ring that fits
no column slice, B not a multiple of 128 for the counts kernel, a hotmx
tile other than 32, 64, 80 or 128 rows, ids that overflow shared memory)
raise on either device. No path of the package calls these:
their entry point is ``graphsage_tpu_torch.benchmarks.gather_probe``.
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
# K7a's ring by default: three stages of the widest column slice that
# fits (ring_slice), each of as many output rows as make RING_STAGE_BYTES
# of whole rows (ring_rows): at the probe's shape whole rows, one output
# row a stage for f32, two for bf16
RING_STAGES = 3
RING_STAGE_BYTES = 65_536
SMEM_BYTES = 232_448        # a block's shared memory on the H100 (opt-in)
HOT_TILE = 128              # K7b's B multiple, the JAX HOT_TILE
MAX_COUNT = 256             # counts stay exact in bf16 up to S = 256
# csrc/gather_probe.cu's K7b/K7c layout: a ring of hot stages, a window
# of counts
HOT_STAGES = 4
TILE_COLS = 64              # output columns a block
SWIZZLE_ROW = 128           # bytes a hot stage row (128-byte swizzle)
COUNT_ROWS = 64             # K7b's rows a block
COUNT_KC = 64               # K7b's hot ids a stage
COUNT_WINDOW = 512          # K7b's ids a count window (bf16)
MX_KC = 32                  # K7c's hot ids a stage
MX_WINDOW = 128             # K7c's ids a count window (f32)
MX_TILES = (32, 64, 80, 128)   # K7c's rows a block (wgmma's N)
# K7c's default: at the probe's B 1024 and F 640 its 130 blocks fill
# the H100's 132 SMs (the fastest tile there, chip_smoke.py's K7c line)
MX_TILE_B = 80


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
                    K: int) -> torch.Tensor:
    """Plain version of K7c: (1/S) * (C @ features[:K] + the sum of the
    row's cold samples, id >= K), in f32."""
    B, S = idx.shape
    hot = hot_counts(idx, K) @ features[:K].float()
    rows = features.index_select(0, idx.reshape(-1)).float()
    rows = rows.view(B, S, features.shape[1])
    cold = torch.where((idx >= K)[:, :, None], rows, torch.zeros_like(rows))
    return (hot + cold.sum(dim=1)) * (1.0 / S)


# ------------------------------------------------------ shapes, checks

def full_bars(wait: str, tile_b: int, W: int) -> int:
    """A K7a stage's full mbarriers: one per slot, per row or per stage."""
    return {"sample": tile_b * W, "row": tile_b, "tile": 1}[wait]


def ring_bytes(wait: str, n_buf: int, tile_b: int, W: int,
               slice_bytes: int) -> int:
    """K7a's shared memory: n_buf stages of tile_b x W column slices, each
    stage's mbarriers (its full ones, an empty one, an ids one), each
    stage's ids and live buckets, rounded up to 16 bytes (the layout of
    ``csrc/gather_probe.cu::probe_gather_kernel``)."""
    slots = tile_b * W
    n = (n_buf * slots * slice_bytes
         + 8 * n_buf * (full_bars(wait, tile_b, W) + 2)
         + 4 * n_buf * slots + 4 * n_buf * tile_b)
    return -(-n // 16) * 16


def hotcount_bytes(S: int) -> int:
    """K7b's shared memory: the ring of hot stages, the counts' window,
    the mbarriers, each row's runs and hot ids, the tile's ids staged
    and sorted, and 1024 bytes of slack for the ring's alignment
    (``csrc/gather_probe.cu::hotcount_bytes``)."""
    return (HOT_STAGES * COUNT_KC * SWIZZLE_ROW + COUNT_ROWS * COUNT_WINDOW * 2
            + 16 * HOT_STAGES + 8 * COUNT_ROWS + 8 * COUNT_ROWS * S + 1024)


def hotmx_bytes(tile_b: int, S: int) -> int:
    """K7c's shared memory at tile_b rows a block: the ring of hot stages
    (two 128-byte boxes a stage row), the counts' window, the cold sums
    and the flushed f32 sums, the mbarriers, each row's runs, hot and
    cold ids, the tile's ids staged and sorted, and 1024 bytes of slack
    (``csrc/gather_probe.cu::hotmx_bytes``). K does not enter it."""
    return (HOT_STAGES * (TILE_COLS * 4 // SWIZZLE_ROW) * MX_KC * SWIZZLE_ROW
            + tile_b * MX_WINDOW * 4 + 2 * tile_b * TILE_COLS * 4
            + 16 * HOT_STAGES + 12 * tile_b + 8 * tile_b * S + 1024)


def column_slice(F: int, elem: int, smem) -> int:
    """FC: the widest divisor of F whose slice is a multiple of 16 bytes
    and whose shared memory ``smem(FC)`` fits a block; ValueError where
    none does."""
    for FC in range(F, 0, -1):
        if F % FC or (FC * elem) % 16:
            continue
        if smem(FC) <= SMEM_BYTES:
            return FC
    raise ValueError(
        f"no column slice of F = {F} ({elem}-byte elements) fits a block's "
        f"{SMEM_BYTES} bytes of shared memory; use a smaller tile_b or n_buf"
    )


def ring_rows(F: int, elem: int, W: int) -> int:
    """K7a's default rows a stage: as many whole rows of W slots as fit
    ``RING_STAGE_BYTES``, at least one."""
    return max(1, RING_STAGE_BYTES // max(1, W * F * elem))


@functools.cache
def ring_slice(F: int, elem: int, wait: str, n_buf: int, tile_b: int,
               W: int) -> int:
    """FC: K7a's column slice, the widest of which n_buf stages of tile_b
    rows of W slots fit (cached: the wrappers ask at every call)."""
    return column_slice(F, elem, lambda fc: ring_bytes(
        wait, n_buf, tile_b, W, fc * elem))


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


def _ring_rows(features: torch.Tensor, W: int, tile_b: int | None) -> int:
    if tile_b is not None:
        return tile_b
    return ring_rows(features.shape[1], features.element_size(), W)


def _check_ring(tile_b: int, n_buf: int) -> None:
    if tile_b < 1 or n_buf < 1:
        raise ValueError(f"tile_b and n_buf must be >= 1, got {tile_b}, "
                         f"{n_buf}")


_GATHER_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_void_p])
_HOTCOUNT_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong, ctypes.c_void_p])
_HOTMX_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
               + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])


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
            raise ValueError("bulk copies and TMA need 16-byte aligned "
                             "tensors")


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
                 wait: str = "sample", tile_b: int | None = None,
                 n_buf: int = RING_STAGES) -> torch.Tensor:
    """[B, F] f32 mean of features[idx] over S, through K7a's ring of
    ``n_buf`` stages of ``tile_b`` rows (by default ``ring_rows``;
    ``ring_slice`` picks the column slice), waited for per ``wait``
    (sample, row or tile). features [N+1, F] f32 or bf16, idx
    [B, S] int32 in [0, N+1). Launches counted in
    ``probe_gather.launches[wait]``."""
    _check_table(features)
    _check_ids(idx, features)
    tile_b = _ring_rows(features, idx.shape[1], tile_b)
    _check_ring(tile_b, n_buf)
    if wait not in WAITS:
        raise ValueError(f"wait must be one of {WAITS}, got {wait!r}")
    S, (_, F), elem = idx.shape[1], features.shape, features.element_size()
    FC = ring_slice(F, elem, wait, n_buf, tile_b, S)
    if features.device.type == "cpu":
        return gather_mean_reference(features, idx)
    _check_device(features, "probe_gather")
    out = _launch_ring(features, idx, None, S, S, FC, tile_b, n_buf, 0,
                       wait, "plain")
    probe_gather.launches[wait] += 1
    return out


probe_gather.launches = dict.fromkeys(WAITS, 0)   # K7a plain/bulk/tilewait


def probe_gather_hot(features: torch.Tensor, idx: torch.Tensor, K: int,
                     tile_b: int | None = None,
                     n_buf: int = RING_STAGES) -> torch.Tensor:
    """As ``probe_gather`` with per-sample waits, the ids below K read
    straight from the table (K7a hot; ``probe_gather_hot.launches``)."""
    _check_table(features)
    _check_ids(idx, features)
    tile_b = _ring_rows(features, idx.shape[1], tile_b)
    _check_ring(tile_b, n_buf)
    if not 0 <= K < 2**31:
        raise ValueError(f"K must be in [0, 2**31), got {K}")
    S, (_, F), elem = idx.shape[1], features.shape, features.element_size()
    FC = ring_slice(F, elem, "sample", n_buf, tile_b, S)
    if features.device.type == "cpu":
        return gather_mean_reference(features, idx)
    _check_device(features, "probe_gather_hot")
    out = _launch_ring(features, idx, None, S, S, FC, tile_b, n_buf, K,
                       "sample", "hot")
    probe_gather_hot.launches += 1
    return out


probe_gather_hot.launches = 0


def probe_coldsw(features: torch.Tensor, idx_dma: torch.Tensor,
                 nb: torch.Tensor, S: int, tile_b: int | None = None,
                 n_buf: int = RING_STAGES) -> torch.Tensor:
    """[B, F] f32: (1/S) x the sum of each row's first 4 x nb[b] slots of
    idx_dma [B, SW] (SW a multiple of 4, nb [B] int32 in [0, SW/4]),
    through K7a's ring with one wait per row (K7a compacted;
    ``probe_coldsw.launches``)."""
    _check_table(features)
    _check_compacted(idx_dma, nb, features)
    tile_b = _ring_rows(features, idx_dma.shape[1], tile_b)
    _check_ring(tile_b, n_buf)
    SW = idx_dma.shape[1]
    if S < 1:
        raise ValueError(f"S must be >= 1, got {S}")
    F, elem = features.shape[1], features.element_size()
    FC = ring_slice(F, elem, "row", n_buf, tile_b, SW)
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
                 hotcount_bytes(S), _stream())
    _raise_on_error(err, SOURCE)
    probe_hotcount.launches += 1
    return out


probe_hotcount.launches = 0


def probe_hotmx(features: torch.Tensor, idx: torch.Tensor, K: int,
                tile_b: int = MX_TILE_B) -> torch.Tensor:
    """[B, F] f32 = (1/S) x (C @ features[:K] + the row's cold samples,
    id >= K): the hot part in 2xTF32 on the tensor cores, the cold rows
    summed beside it, from the raw ids (K7c, the whole function;
    ``probe_hotmx.launches``). features f32, K <= its rows, tile_b rows
    a block, one of ``MX_TILES``."""
    _check_table(features)
    if features.dtype != torch.float32:
        raise TypeError(f"hotmx takes an f32 table, got {features.dtype}")
    _check_ids(idx, features)
    if tile_b not in MX_TILES:
        raise ValueError(f"tile_b must be one of {MX_TILES} (wgmma's N), "
                         f"got {tile_b}")
    if not 0 <= K <= features.shape[0]:
        raise ValueError(f"K must be in [0, {features.shape[0]}], got {K}")
    B, S = idx.shape
    smem = hotmx_bytes(tile_b, S)
    if smem > SMEM_BYTES:
        raise ValueError(f"S = {S} ids of {tile_b} rows need {smem} bytes of "
                         f"shared memory, more than a block's {SMEM_BYTES}; "
                         f"use a smaller tile_b")
    if features.device.type == "cpu":
        return hotmx_reference(features, idx, K)
    _check_device(features, "probe_hotmx")
    F = features.shape[1]
    out = torch.empty((B, F), dtype=torch.float32, device=features.device)
    _check_aligned(features, out)
    fn = _fn("graphsage_probe_hotmx", tuple(_HOTMX_ARGS))
    with torch.cuda.device(features.device):
        err = fn(features.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 features.shape[0], B, S, F, K, tile_b, smem, _stream())
    _raise_on_error(err, SOURCE)
    probe_hotmx.launches += 1
    return out


probe_hotmx.launches = 0
