"""The gather-mean probe's port (graphsage_tpu_torch/ops/gather_probe.py,
graphsage_tpu_torch/benchmarks/gather_probe.py) against the JAX package's
benchmarks/gather_probe.py, whose Pallas kernels run in interpret mode on
the CPU at a toy size (its module constants set by monkeypatch): every
kind's plain version on the same numpy table and ids, make_ids, the id
compactions against a numpy restatement, why K7c's hot product takes two
TF32 passes, K7b's and K7c's count build (sorted ids, a cursor, a ring of
count stages) restated in Python, their shared-memory layouts against the
CUDA source's, and the wrappers' checks and CPU routing."""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.gather_probe as jgp
from graphsage_tpu_torch.benchmarks import gather_probe as tgp
from graphsage_tpu_torch.benchmarks import probe_breakdown, ring_timeline
from graphsage_tpu_torch.ops import build
from graphsage_tpu_torch.ops import gather_probe as ops
from graphsage_tpu_torch.ops.pool import tf32_split
from tests._torch_common import t

PALLAS_CALL = jgp.pl.pallas_call
TOY = dict(N=300, F=128, B=128)
K = 16
F32_TOL = 1e-6      # max abs error of the f32 kinds (measured <= 2.4e-7)
BF16_HOT_TOL = 1e-5  # hotcount/hc against the JAX kernel, same bf16 block


def _toy(monkeypatch, S: int) -> None:
    for mod in (jgp, tgp):
        for name, value in dict(TOY, S=S).items():
            monkeypatch.setattr(mod, name, value)
    monkeypatch.setattr(jgp.pl, "pallas_call",
                        functools.partial(PALLAS_CALL, interpret=True))


def _inputs(S: int, seed: int):
    """The JAX probe's table (standard normal, zero dummy row N) and zipf
    ids, with row 0 all hot and row 1 all cold (the dummy row among
    them)."""
    rng = np.random.default_rng(seed)
    N, F = TOY["N"], TOY["F"]
    feats = np.vstack([rng.standard_normal((N, F)).astype(np.float32),
                       np.zeros((1, F), np.float32)])
    idx = jgp.make_ids("zipf", rng, 1)[0]
    idx[0] = rng.integers(0, K, S)
    idx[1] = rng.integers(K, N + 1, S)
    idx[1, 0] = N
    return feats, idx


def _jax(kind, feats, idx):
    N, F = TOY["N"], TOY["F"]
    fview = jnp.asarray(feats).reshape(N + 1, 1, F)
    hb16 = jnp.asarray(feats, dtype=jnp.bfloat16)[:K]
    fn = jgp.build_call(kind, "float32", K=K)
    extra = {"hot": (fview, fview[:K]), "hotmx": (fview, feats[:K]),
             "hotcount": (hb16,), "hc": (fview, hb16)}.get(kind, (fview,))
    return np.asarray(fn(jnp.asarray(idx), *extra))


def _port(kind, feats, idx):
    table = t(feats)
    hb16 = table.to(torch.bfloat16)[:K]
    fn = tgp.build_call(kind, torch.float32, K=K)
    extra = {"hotcount": (hb16,), "hc": (table, hb16)}.get(kind, (table,))
    return fn(t(idx), *extra).numpy()


@pytest.mark.parametrize("kind,S", [
    (kind, 5) for kind in ("plain", "bulkwait", "tilewait", "hot", "hotmx",
                           "coldsw", "hotcount", "hc")
] + [("bulkwait", 25), ("hotmx", 25), ("hc", 25)])
def test_plain_versions_match_the_jax_probe(monkeypatch, kind, S):
    """Each kind's plain version against the JAX kernel (interpret mode),
    K = 16: f32 kinds to 1e-6, hotcount/hc (bf16 hot block on both
    sides) to 1e-5."""
    _toy(monkeypatch, S)
    feats, idx = _inputs(S, seed=S)
    want = _jax(kind, feats, idx)
    got = _port(kind, feats, idx)
    assert got.shape == want.shape == (TOY["B"], TOY["F"])
    tol = BF16_HOT_TOL if kind in ("hotcount", "hc") else F32_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("toy", [True, False])
def test_make_ids_is_bit_equal(monkeypatch, dist, toy):
    if toy:
        _toy(monkeypatch, 5)
    want = jgp.make_ids(dist, np.random.default_rng(3), 2)
    got = tgp.make_ids(dist, np.random.default_rng(3), 2)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _np_compact(idx, idx_sorted, nc, N):
    S = idx.shape[1]
    pos = np.arange(S)[None, :]
    idx_dma = np.where(pos < nc[:, None], idx_sorted, N)
    pad = -(-S // 4) * 4 - S
    return np.concatenate([idx_dma, np.full((idx.shape[0], pad), N)], 1)


def _np_stable(idx, K, N):
    """gather_probe.py:559-575 in numpy."""
    is_cold = idx >= K
    nc = is_cold.sum(1)
    order = np.argsort((~is_cold).astype(np.int32), axis=1, kind="stable")
    idx_dma = _np_compact(idx, np.take_along_axis(idx, order, 1), nc, N)
    return idx_dma, (nc + 3) // 4


def _np_topk(idx, K, N):
    """gather_probe.py:619-635 in numpy (top_k: descending)."""
    nc = (idx >= K).sum(1)
    idx_dma = _np_compact(idx, -np.sort(-idx, axis=1), nc, N)
    nb = (nc + 3) // 4
    mask = (np.arange(idx_dma.shape[1])[None, :] < 4 * nb[:, None])
    return idx_dma, nb, mask.astype(np.float32)


@pytest.mark.parametrize("S", [1, 4, 5, 25])
def test_compactions_match_numpy(S):
    """idx_dma, nb and the live mask exactly, rows all hot and all cold
    included."""
    N = 300
    rng = np.random.default_rng(S)
    idx = rng.integers(0, N + 1, (12, S), dtype=np.int32)
    idx[0] = rng.integers(0, K, S)          # all hot
    idx[1] = rng.integers(K, N + 1, S)      # all cold
    idx[2] = K                              # all cold, at the boundary
    idx_dma, nb = ops.cold_first_stable(t(idx), K, N)
    want_dma, want_nb = _np_stable(idx, K, N)
    np.testing.assert_array_equal(idx_dma.numpy(), want_dma)
    np.testing.assert_array_equal(nb.numpy(), want_nb)
    assert idx_dma.dtype == nb.dtype == torch.int32
    assert nb[0] == 0 and nb[1] == nb[2] == (S + 3) // 4
    idx_dma, nb, mask = ops.cold_first_topk(t(idx), K, N)
    want_dma, want_nb, want_mask = _np_topk(idx, K, N)
    np.testing.assert_array_equal(idx_dma.numpy(), want_dma)
    np.testing.assert_array_equal(nb.numpy(), want_nb)
    np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_hot_product_needs_two_tf32_passes():
    """K7c's hot product, emulated: counts (exact in TF32) @ the hot rows
    split by tf32_split, summed in f32. hi + lo meets 1e-5 of the exact
    product over S; hi alone (one TF32 pass) does not."""
    rng = np.random.default_rng(0)
    S, n_hot = 25, 64
    hot = rng.standard_normal((n_hot, 128)).astype(np.float32)
    idx = rng.integers(0, 2 * n_hot, (128, S), dtype=np.int32)
    counts = ops.hot_counts(t(idx), n_hot)
    exact = (counts.double() @ t(hot).double()) / S
    hi, lo = tf32_split(t(hot))
    two = ((counts @ hi) + (counts @ lo)) * (1.0 / S)
    one = (counts @ hi) * (1.0 / S)
    assert float((two.double() - exact).abs().max()) <= 1e-5
    assert float((one.double() - exact).abs().max()) > 1e-5


def test_column_slices():
    """The ring's column slice at the probe's shape: 128 f32 or 160 bf16
    columns (divisors of 640) at tile_b 8, S 25, n_buf 2; K7c takes 64
    columns a block at every tile, its layout well inside a block's
    shared memory at S 25."""
    def slice_of(elem, wait="sample", tile_b=8, n_buf=2, W=25):
        return ops.column_slice(640, elem, lambda fc: ops.ring_bytes(
            wait, n_buf, tile_b, W, fc * elem))

    assert slice_of(4) == 128 and slice_of(2) == 160
    assert slice_of(4, "row", 16) == 64
    assert ops.TILE_COLS == 64 and 640 % ops.TILE_COLS == 0
    assert all(ops.hotmx_bytes(tb, 25) <= ops.SMEM_BYTES
               for tb in ops.MX_TILES)
    with pytest.raises(ValueError, match="no column slice"):
        slice_of(4, tile_b=256, n_buf=4)


@pytest.mark.parametrize("F,elem,W,want", [
    (640, 4, 25, 1),    # the probe's f32 rows: 64,000 bytes a row's slots
    (640, 2, 25, 2),    # bf16: two rows of 32,000 bytes
    (640, 4, 28, 1),    # the compacted slots of S = 25
    (16, 4, 25, 40),    # narrow rows: 40 rows make 64,000 bytes
    (640, 4, 40, 1),    # more bytes than a stage's: still one row
])
def test_ring_rows(F, elem, W, want):
    """K7a's default rows a stage: whole rows up to 65,536 bytes."""
    assert ops.ring_rows(F, elem, W) == want


@pytest.mark.parametrize("elem,wait,tile_b,n_buf,W,want", [
    # the defaults at the probe's shape: 3 stages of whole rows fit
    (4, "sample", 1, 3, 25, 640),
    (4, "row", 1, 3, 25, 640),
    (4, "tile", 1, 3, 25, 640),
    (2, "sample", 2, 3, 25, 640),
    (4, "row", 1, 3, 28, 640),       # compacted, SW = 28
    # deeper rings take narrower slices
    (4, "sample", 1, 4, 25, 320),
    (4, "sample", 1, 7, 25, 320),
    (4, "sample", 8, 2, 25, 128),
    (2, "tile", 8, 2, 25, 160),
])
def test_ring_slice(elem, wait, tile_b, n_buf, W, want):
    """K7a's column slice at the probe's F = 640: the widest divisor whose
    n_buf stages fit a block."""
    assert ops.ring_slice(640, elem, wait, n_buf, tile_b, W) == want


def test_ring_bytes_by_hand():
    """3 stages of one row of 25 whole f32 rows: the slices, 27 mbarriers
    a stage (25 full, an empty, an ids), 25 ids and a live bucket count
    a stage; per-row and per-stage waits keep 1 + 2 mbarriers a stage at
    one row; a fourth stage does not fit."""
    slices, ids, nbs = 3 * 25 * 2560, 4 * 3 * 25, 4 * 3
    assert ops.ring_bytes("sample", 3, 1, 25, 2560) == \
        slices + 8 * 3 * 27 + ids + nbs == 192960
    assert ops.ring_bytes("row", 3, 1, 25, 2560) == \
        -(-(slices + 8 * 3 * 3 + ids + nbs) // 16) * 16 == 192384
    assert ops.ring_bytes("tile", 3, 1, 25, 2560) == 192384
    assert ops.ring_bytes("row", 2, 8, 25, 512) == \
        -(-(2 * 200 * 512 + 8 * 2 * 10 + 4 * 2 * 200 + 4 * 2 * 8) // 16) * 16
    for wait in ops.WAITS:
        assert ops.ring_bytes(wait, 3, 1, 25, 2560) <= ops.SMEM_BYTES
        assert ops.ring_bytes(wait, 4, 1, 25, 2560) > ops.SMEM_BYTES


CU_SOURCE = build.CSRC / "gather_probe.cu"


def _cu_constants():
    """The constexpr ints of csrc/gather_probe.cu that its K7b/K7c
    layouts are built from."""
    text = CU_SOURCE.read_text()
    return {name: int(value) for name, value in re.findall(
        r"constexpr (?:int|uint32_t|size_t) (k\w+) = (\d+);", text)}


def test_layout_constants_mirror_the_cuda_source():
    """ops/gather_probe.py's sizes use csrc/gather_probe.cu's numbers."""
    c = _cu_constants()
    assert (c["kHotStages"], c["kTileCols"], c["kSwizzleRow"],
            c["kCountRows"], c["kCountKC"], c["kCountWindow"], c["kMxKC"],
            c["kMxWindow"], c["kCountB"]) == (
        ops.HOT_STAGES, ops.TILE_COLS, ops.SWIZZLE_ROW, ops.COUNT_ROWS,
        ops.COUNT_KC, ops.COUNT_WINDOW, ops.MX_KC, ops.MX_WINDOW,
        ops.HOT_TILE)
    assert c["kSmemLimit"] == ops.SMEM_BYTES
    tiles = re.findall(r"tile_b != (\d+)", CU_SOURCE.read_text())
    assert tuple(int(x) for x in tiles) == ops.MX_TILES


@pytest.mark.parametrize("K", [1024, 4096])
@pytest.mark.parametrize("tile_b", [32, 64, 80, 128])
def test_layouts_at_the_probe_shape_fit(K, tile_b):
    """At the probe's S = 25 (B 1024, F 640): K7b's layout and K7c's at
    each tile fit the 232,448 bytes, whatever K (the hot block streams
    through a fixed ring, the counts through a fixed window); bytes as
    the layouts add up: 4 ring stages of hot rows (8 KB), the counts'
    window (K7b 64 rows x 512 bf16, K7c rows x 128 f32), K7c's cold and
    flushed sums (rows x 256 each), the mbarriers 64, each row's run,
    hot (and K7c's cold) counts 4 bytes each, the ids 8 x rows x S, 1 KB
    of alignment slack."""
    ids = 8 * 25
    assert ops.hotcount_bytes(25) == 4 * 8192 + 64 * 1024 + 64 + 64 * 8 \
        + 64 * ids + 1024 == 112704
    want = 4 * 8192 + tile_b * 512 + 2 * tile_b * 256 + 64 + tile_b * 12 \
        + tile_b * ids + 1024
    assert ops.hotmx_bytes(tile_b, 25) == want <= ops.SMEM_BYTES
    assert ops.hotcount_bytes(ops.MAX_COUNT) <= ops.SMEM_BYTES
    table = torch.zeros((K + 1, 640))
    idx = torch.full((tile_b, 25), K, dtype=torch.int32)
    out = ops.probe_hotmx(table, idx, K, tile_b=tile_b)
    assert out.shape == (tile_b, 640) and not out.any()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_layouts_refuse_what_does_not_fit(device):
    """S = 200 ids of 128 rows overflow K7c's shared memory: ValueError
    before any device work; 64 rows fit."""
    assert ops.hotmx_bytes(128, 200) > ops.SMEM_BYTES
    assert ops.hotmx_bytes(64, 200) <= ops.SMEM_BYTES
    table = torch.zeros((21, 16), device=device)
    idx = torch.zeros((128, 200), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        ops.probe_hotmx(table, idx, 4, tile_b=128)


def _bitonic_warp(keys):
    """The warp-wide bitonic network of csrc/gather_probe.cu::sort_rows on
    32 lanes (lane i holds keys[i]), as its shuffles run it."""
    key = list(keys)
    k = 2
    while k <= 32:
        j = k // 2
        while j:
            other = [key[lane ^ j] for lane in range(32)]
            key = [min(key[l], other[l]) if ((l & j) == 0) == ((l & k) == 0)
                   else max(key[l], other[l]) for l in range(32)]
            j //= 2
        k *= 2
    return key


INT32_MAX = 2**31 - 1


def _runs_of_warp(key, nh):
    """The runs of sorted hot ids as csrc/gather_probe.cu::sort_rows
    finds them across a warp: a run starts at a lane whose id differs
    from the lane before; its length runs to the next start (or nh)."""
    starts = [lane for lane in range(nh)
              if lane == 0 or key[lane] != key[lane - 1]]
    return [(key[lane], (starts[j + 1] if j + 1 < len(starts) else nh) - lane)
            for j, lane in enumerate(starts)]


def _emulate_count_build(idx: np.ndarray, K: int, kernel: str):
    """K7b's and K7c's count build in Python, as csrc/gather_probe.cu
    runs it: each row's hot ids sorted by the bitonic network (S <= 32;
    the others as INT32_MAX) into runs of equal ids, then written by the
    row's owner into a window of counts one window at a time (K7b 512
    ids, K7c 128): the places the window held reset to 0, each run in
    the new window written once as its length. Each window is checked to
    hold exactly its ids' counts when the products read it. Returns the
    [B, K] counts the windows held."""
    B, S = idx.shape
    width = {"K7b": 512, "K7c": 128}[kernel]
    counts = np.zeros((B, K), np.float32)
    for r in range(B):
        row = idx[r]
        keys = [int(v) if 0 <= v < K else INT32_MAX for v in row]
        key = _bitonic_warp(keys + [INT32_MAX] * (32 - S))
        assert key == sorted(keys + [INT32_MAX] * (32 - S))
        runs = _runs_of_warp(key, sum(v != INT32_MAX for v in keys))
        window = np.zeros(width, np.float32)
        cur = first = end = old = 0     # the window holds runs[first:end]
        for base in range(0, K, width):
            for i in range(first, end):
                window[runs[i][0] - old] = 0
            first = cur
            while cur < len(runs) and runs[cur][0] < base + width:
                window[runs[cur][0] - base] = runs[cur][1]
                cur += 1
            end, old = cur, base
            live = row[(row >= base) & (row < min(K, base + width))] - base
            np.testing.assert_array_equal(
                window, np.bincount(live, minlength=width))
            counts[r, base:base + width] = window[:K - base]
    return counts


@pytest.mark.parametrize("kernel", ["K7b", "K7c"])
@pytest.mark.parametrize("case", ["zipf", "duplicates", "K0", "past_K",
                                  "ragged_K"])
def test_cursor_count_build_equals_hot_counts(kernel, case):
    """The count build from sorted runs (K7b's and K7c's count windows)
    gives hot_counts exactly: repeated ids in a row, K = 0, ids past K
    (never counted) and a K that ends inside a window."""
    rng = np.random.default_rng(len(case))
    KC = 512 if kernel == "K7b" else 128
    K = {"K0": 0, "ragged_K": 3 * KC + 5}.get(case, 4 * KC)
    S = 25
    idx = rng.integers(0, 6 * KC, (12, S), dtype=np.int32)
    if case == "zipf":
        idx = (rng.zipf(1.3, (12, S)) - 1).clip(0, 6 * KC).astype(np.int32)
    if case == "duplicates":
        idx[:, ::2] = idx[:, :1]           # one id in half a row's samples
        idx[1] = KC - 1                    # a whole row of one id
        idx[2, :5] = KC                    # a run across a stage boundary
        idx[2, 5:10] = KC - 1
    if case == "past_K":
        idx[3] = K + rng.integers(0, 9, S)     # no hot id at all
        idx[4] = K - 1                         # the last hot id only
    got = _emulate_count_build(idx, K, kernel)
    want = ops.hot_counts(t(idx), K).numpy()
    np.testing.assert_array_equal(got, want)


def _toy_table(F=16, dtype=torch.float32):
    return torch.randn(21, F).to(dtype), torch.randint(
        0, 21, (128, 5), dtype=torch.int32)


@pytest.mark.parametrize("F,dtype", [(602, torch.float32),
                                     (602, torch.bfloat16)])
def test_row_pitch_not_16_bytes_raises(F, dtype):
    table, idx = _toy_table(F, dtype)
    for call in (lambda: ops.probe_gather(table, idx),
                 lambda: ops.probe_gather_hot(table, idx, 4),
                 lambda: ops.probe_hotmx(table.float(), idx, 4)):
        with pytest.raises(ValueError, match="pitch"):
            call()


def test_unsupported_shapes_raise():
    table, idx = _toy_table()
    hot = table[:8].to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.probe_hotcount(idx[:16], hot)
    with pytest.raises(ValueError, match="multiple of 128"):
        tgp.build_call("hc", torch.float32, K=8)(idx[:16], table, hot)
    for tile_b in (8, 16, 96, 256):
        with pytest.raises(ValueError, match="tile_b must be one of"):
            ops.probe_hotmx(table, idx, 4, tile_b=tile_b)
    with pytest.raises(TypeError, match="f32 table"):
        ops.probe_hotmx(table.to(torch.bfloat16), idx, 4)
    with pytest.raises(ValueError, match="K must be in"):
        ops.probe_hotmx(table, idx, table.shape[0] + 1)
    with pytest.raises(ValueError, match="no column slice"):
        ops.probe_gather(table, idx, tile_b=2048, n_buf=8)
    with pytest.raises(ValueError, match="wait"):
        ops.probe_gather(table, idx, "granule")


def _calls(table, idx):
    idx_dma, nb, _ = ops.cold_first_topk(idx, 4, table.shape[0] - 1)
    hot = table[:8].to(torch.bfloat16)
    return {
        "sample": lambda: ops.probe_gather(table, idx, "sample"),
        "row": lambda: ops.probe_gather(table, idx, "row"),
        "tile": lambda: ops.probe_gather(table, idx, "tile"),
        "hot": lambda: ops.probe_gather_hot(table, idx, 4),
        "coldsw": lambda: ops.probe_coldsw(table, idx_dma, nb, 5),
        "hotcount": lambda: ops.probe_hotcount(idx, hot),
        "hotmx": lambda: ops.probe_hotmx(table, idx, 4),
    }


@pytest.mark.parametrize("kind", ["sample", "row", "tile", "hot", "coldsw",
                                  "hotcount", "hotmx"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, kind):
    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    table, idx = _toy_table()
    before = (dict(ops.probe_gather.launches), ops.probe_gather_hot.launches,
              ops.probe_coldsw.launches, ops.probe_hotcount.launches,
              ops.probe_hotmx.launches)
    out = _calls(table, idx)[kind]()
    assert out.shape == (128, 16) and out.dtype == torch.float32
    assert before == (ops.probe_gather.launches,
                      ops.probe_gather_hot.launches,
                      ops.probe_coldsw.launches,
                      ops.probe_hotcount.launches, ops.probe_hotmx.launches)
    if kind in ("sample", "row", "tile", "hot"):
        torch.testing.assert_close(out, ops.gather_mean_reference(table, idx),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["sample", "row", "tile", "hot", "coldsw",
                                  "hotcount", "hotmx"])
def test_other_devices_raise_without_computing(monkeypatch, kind):
    """A tensor on neither the CPU nor a card reaches no plain version."""
    def no_plain(*a):
        raise AssertionError("only CPU tensors take the plain version")

    for name in ("gather_mean_reference", "coldsw_reference",
                 "hotcount_reference", "hotmx_reference"):
        monkeypatch.setattr(ops, name, no_plain)
    table = torch.zeros((21, 16), device="meta")
    idx = torch.zeros((128, 5), dtype=torch.int32, device="meta")
    idx_dma = torch.zeros((128, 8), dtype=torch.int32, device="meta")
    nb = torch.zeros(128, dtype=torch.int32, device="meta")
    calls = {
        "sample": lambda: ops.probe_gather(table, idx, "sample"),
        "row": lambda: ops.probe_gather(table, idx, "row"),
        "tile": lambda: ops.probe_gather(table, idx, "tile"),
        "hot": lambda: ops.probe_gather_hot(table, idx, 4),
        "coldsw": lambda: ops.probe_coldsw(table, idx_dma, nb, 5),
        "hotcount": lambda: ops.probe_hotcount(
            idx, torch.zeros((8, 16), dtype=torch.bfloat16, device="meta")),
        "hotmx": lambda: ops.probe_hotmx(table, idx, 4),
    }
    with pytest.raises(ValueError, match="cuda or cpu"):
        calls[kind]()


ALL_VARIANTS = ("xla_f32,xla_bf16,xla_sorted,k1,plain,bulkwait,tilewait,"
                "plain_sorted,plain_t16b2,plain_t4b1,bulkwait_t1b2,"
                "tilewait_t2b3,hot16,hot16_bf16,"
                "hotmx16,hotmx16t32,coldsw16,coldsw16_bf16,hotcount16,hc16,"
                "prep,plain_bf16,bulkwait_bf16,tilewait_bf16")


def _small_probe(monkeypatch):
    for name, value in dict(TOY, N=300, S=25, ITERS=1, INNER=2).items():
        monkeypatch.setattr(tgp, name, value)


def test_entry_point_runs_every_variant_on_the_cpu(monkeypatch, capsys):
    """Every variant name of the JAX probe, plus k1, through the plain
    versions: one line each, no failure, exit code 0."""
    _small_probe(monkeypatch)
    assert tgp.main(["--device", "cpu", "--variants", ALL_VARIANTS]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# dist=zipf B=128 S=25 F=128 N=300")
    names = ALL_VARIANTS.split(",")
    assert [ln.split()[0] for ln in lines[1:]] == names
    assert all("ms" in ln and "Mrow/s" in ln for ln in lines[1:])


def test_probe_hotmx_line_calls_no_compaction(monkeypatch, capsys):
    """K7c reads the raw ids: the probe's hotmx lines (the default tile
    and t32) run and agree with the plain mean while every id compaction
    raises."""
    def no_compaction(*a):
        raise AssertionError("hotmx needs no id compaction")

    _small_probe(monkeypatch)
    for mod in (ops, tgp):
        for name in ("cold_first_stable", "cold_first_topk"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, no_compaction)
    table, idx = _toy_table()
    out = tgp.build_call("hotmx", torch.float32, K=4)(idx, table)
    torch.testing.assert_close(out, ops.gather_mean_reference(table, idx),
                               rtol=0, atol=1e-6)
    assert tgp.main(["--device", "cpu", "--variants", "hotmx16,hotmx16t32"]) \
        == 0
    assert "FAILED" not in capsys.readouterr().out


def test_entry_point_exits_non_zero_when_a_variant_fails(monkeypatch, capsys):
    _small_probe(monkeypatch)
    assert tgp.main(["--device", "cpu", "--dist", "uniform", "--variants",
                     "plain,hotmx16t8,nonesuch"]) == 1
    out = capsys.readouterr().out
    assert "hotmx16t8    FAILED: ValueError" in out
    assert "nonesuch     FAILED" in out and "plain " in out


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _small_probe(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgp.main(["--variants", "k1"])


@pytest.mark.parametrize("kind", ["plain", "hot", "coldsw", "hotcount",
                                  "hc", "hotmx"])
def test_bounds_count_the_function_not_the_design(kind):
    """Each kind's bound is its bytes (distinct rows, ids, output; the
    bf16 hot block for hotcount/hc) over the memory rate: the mean's
    B x S x F adds take less, and the counts kernels' dense products are
    not counted as work the function needs."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 5000, (2, 1024, 25),
                                        dtype=np.int32))
    K, F = 1024, tgp.F
    ms, by = tgp.bound_ms(kind, ids, 4, K)
    n_bytes = []
    for one in ids:
        rows = torch.unique(one)
        if kind in ("coldsw", "hc", "hotcount"):
            rows = rows[rows >= K]
        n = 1024 * F * 4 + one.numel() * 4
        n += 0 if kind == "hotcount" else rows.numel() * F * 4
        n += K * F * 2 if kind in ("hotcount", "hc") else 0
        n_bytes.append(n)
    assert by == "bytes"
    assert ms == pytest.approx(np.mean(n_bytes) / tgp.HBM_BYTES_PER_S * 1e3,
                               rel=1e-12)


@pytest.mark.parametrize("name", list(probe_breakdown.VARIANTS))
def test_breakdown_copies_find_their_text(name):
    """Each copy of benchmarks/probe_breakdown.py switches its part off
    where the CUDA source has it, once; "as built" is the source."""
    text = (build.CSRC / "gather_probe.cu").read_text()
    out = probe_breakdown.variant_source(name, text)
    assert (out == text) == (name == "as built")
    with pytest.raises(ValueError, match="occurs 0 times"):
        probe_breakdown.variant_source("no cold half", "")


def test_breakdown_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_breakdown.main()


def test_ring_timeline_matches_the_stamps_in_the_source():
    """ring_timeline's stamp layout is the kernel's: kStampItems items,
    the Stamp events in order, kConsumerGroups groups taking the items
    in turn."""
    text = (build.CSRC / "gather_probe.cu").read_text()
    items = re.search(r"constexpr int kStampItems = (\d+);", text)
    assert int(items.group(1)) == ring_timeline.STAMP_ITEMS
    groups = re.search(r"constexpr int kConsumerGroups = (\d+);", text)
    assert int(groups.group(1)) == ring_timeline.CONSUMER_GROUPS
    enum = re.search(r"enum Stamp \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names == ["kFillStart", "kStageFree", "kIssued", "kTakeStart",
                     "kIdsReady", "kDataReady", "kSummed", "kStamps"]
    assert len(ring_timeline.EVENTS) == len(names) - 1
    stamped = re.findall(r"RING_STAMP\(k, (k\w+),", text)
    assert sorted(stamped) == sorted(names[:-1])


def test_ring_timeline_segments_by_hand():
    """Three items of block 0, the second taken by the other consumer
    group, the third with no live slot (no data stamp); unstamped items
    are zero rows and are left out."""
    stamps = np.zeros((ring_timeline.STAMP_ITEMS, 7), np.int64)
    #             fill  free issued take  ids  data summed
    stamps[0] = (1000, 1010, 1110, 900, 1120, 1200, 1500)
    stamps[1] = (1200, 1220, 1300, 1000, 1310, 1330, 1600)
    stamps[2] = (1400, 1600, 1700, 1500, 1710, 0, 1800)
    t = ring_timeline.timeline(stamps)
    assert t["items"] == 3
    assert t["span"] == 1800 - 1000
    assert t["stage wait"] == pytest.approx((10 + 20 + 200) / 3)
    assert t["issue"] == pytest.approx((100 + 80 + 100) / 3)
    assert t["ids wait"] == pytest.approx((220 + 310 + 210) / 3)
    assert t["data wait"] == pytest.approx((80 + 20) / 2)
    assert t["sum"] == pytest.approx((300 + 270) / 2)
    # group 0 sums items 0 and 2 (300 + 90), group 1 item 1 (270)
    assert t["sum share"] == pytest.approx(390 / 800)


def test_ring_timeline_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert ring_timeline.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
