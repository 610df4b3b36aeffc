"""The gather-mean probe's port (graphsage_tpu_torch/ops/gather_probe.py,
graphsage_tpu_torch/benchmarks/gather_probe.py) against the JAX package's
benchmarks/gather_probe.py, whose Pallas kernels run in interpret mode on
the CPU at a toy size (its module constants set by monkeypatch): every
kind's plain version on the same numpy table and ids, make_ids, the id
compactions against a numpy restatement, why K7c's hot product takes two
TF32 passes, and the wrappers' checks and CPU routing."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.gather_probe as jgp
from graphsage_tpu_torch.benchmarks import gather_probe as tgp
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
    tile_b = ops.MMA_ROWS if kind == "hotmx" else tgp.TILE_B
    fn = tgp.build_call(kind, torch.float32, K=K, tile_b=tile_b)
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
    columns (divisors of 640) at tile_b 8, S 25, n_buf 2; K7c's at its
    16-row tile."""
    def slice_of(elem, wait="sample", tile_b=8, n_buf=2, W=25):
        return ops.column_slice(640, elem, lambda fc: ops.ring_bytes(
            wait, n_buf, tile_b, W, fc * elem))

    assert slice_of(4) == 128 and slice_of(2) == 160
    assert slice_of(4, "row", 16) == 64
    fc = ops.column_slice(
        640, 4, lambda fc: ops.hotmx_bytes(2, 16, 28, fc, 25), multiple=8,
        max_units=lambda fc: ops.mx_units(16, fc))
    assert fc == 40 and ops.hotmx_bytes(2, 16, 28, fc, 25) <= ops.SMEM_BYTES
    with pytest.raises(ValueError, match="no column slice"):
        slice_of(4, tile_b=256, n_buf=4)


def _toy_table(F=16, dtype=torch.float32):
    return torch.randn(21, F).to(dtype), torch.randint(
        0, 21, (128, 5), dtype=torch.int32)


@pytest.mark.parametrize("F,dtype", [(602, torch.float32),
                                     (602, torch.bfloat16)])
def test_row_pitch_not_16_bytes_raises(F, dtype):
    table, idx = _toy_table(F, dtype)
    stable = ops.cold_first_stable(idx, 4, 20)
    for call in (lambda: ops.probe_gather(table, idx),
                 lambda: ops.probe_gather_hot(table, idx, 4),
                 lambda: ops.probe_hotmx(table.float(), idx, *stable, 4)):
        with pytest.raises(ValueError, match="pitch"):
            call()


def test_unsupported_shapes_raise():
    table, idx = _toy_table()
    hot = table[:8].to(torch.bfloat16)
    stable = ops.cold_first_stable(idx, 4, 20)
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.probe_hotcount(idx[:16], hot)
    with pytest.raises(ValueError, match="multiple of 128"):
        tgp.build_call("hc", torch.float32, K=8)(idx[:16], table, hot)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.probe_hotmx(table, idx, *stable, 4, tile_b=8)
    with pytest.raises(TypeError, match="f32 table"):
        ops.probe_hotmx(table.to(torch.bfloat16), idx, *stable, 4)
    with pytest.raises(ValueError, match="idx_dma must be"):
        ops.probe_hotmx(table, idx, stable[0][:, :4], stable[1], 4)
    with pytest.raises(ValueError, match="no column slice"):
        ops.probe_gather(table, idx, tile_b=2048, n_buf=8)
    with pytest.raises(ValueError, match="wait"):
        ops.probe_gather(table, idx, "granule")


def _calls(table, idx):
    idx_dma, nb, _ = ops.cold_first_topk(idx, 4, table.shape[0] - 1)
    stable = ops.cold_first_stable(idx, 4, table.shape[0] - 1)
    hot = table[:8].to(torch.bfloat16)
    return {
        "sample": lambda: ops.probe_gather(table, idx, "sample"),
        "row": lambda: ops.probe_gather(table, idx, "row"),
        "tile": lambda: ops.probe_gather(table, idx, "tile"),
        "hot": lambda: ops.probe_gather_hot(table, idx, 4),
        "coldsw": lambda: ops.probe_coldsw(table, idx_dma, nb, 5),
        "hotcount": lambda: ops.probe_hotcount(idx, hot),
        "hotmx": lambda: ops.probe_hotmx(table, idx, *stable, 4),
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
        "hotmx": lambda: ops.probe_hotmx(table, idx, idx_dma, nb, 4),
    }
    with pytest.raises(ValueError, match="cuda or cpu"):
        calls[kind]()


ALL_VARIANTS = ("xla_f32,xla_bf16,xla_sorted,k1,plain,bulkwait,tilewait,"
                "plain_sorted,plain_t16b2,plain_t4b1,hot16,hot16_bf16,"
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
