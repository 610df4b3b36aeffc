"""The port's gather-mean (graphsage_tpu_torch/ops/gather.py) against the
JAX package's Pallas kernel (interpret mode) and reference, the plain
version of K2 (Philox dropout inside the gather-mean) and its generator,
the plain versions of K3 (the deduplicating gather-mean) and K4 (the row
gather) against the JAX package's kernels in interpret mode, and the
wrappers' CPU/CUDA routing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.ops.gather import dedup_compact as jax_dedup_compact
from graphsage_tpu.ops.gather import fused_gather_mean as jax_fused
from graphsage_tpu.ops.gather import fused_gather_rows as jax_fused_rows
from graphsage_tpu.ops.gather import gather_mean_reference as jax_reference
from graphsage_tpu_torch.ops import build, gather, philox
from graphsage_tpu_torch.ops.gather import (
    MAX_DEDUP_SAMPLES,
    dedup_compact,
    fused_gather_mean,
    fused_gather_rows,
    gather_mean_dedup_reference,
    gather_mean_dropout_reference,
    gather_mean_reference,
    gather_rows_reference,
)
from tests._torch_common import t


def _inputs(B, S, F, seed, n=40):
    """A [n+1, F] table whose last row is the zero dummy row, and idx
    whose first row hits only the dummy."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n + 1, F)).astype(np.float32)
    feats[n] = 0.0
    idx = rng.integers(0, n + 1, (B, S), dtype=np.int32)
    idx[0] = n
    return feats, idx


@pytest.mark.parametrize("B,S,F", [(8, 5, 16), (13, 25, 32), (1, 1, 8),
                                   (6, 3, 602)])
def test_gather_mean_matches_jax(B, S, F):
    feats, idx = _inputs(B, S, F, seed=B * 100 + S)
    out = fused_gather_mean(t(feats), t(idx)).numpy()
    plain = gather_mean_reference(t(feats), t(idx)).numpy()
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(out[0], 0.0)  # the dummy row is zeros
    pallas = jax_fused(jnp.asarray(feats), jnp.asarray(idx), interpret=True)
    ref = jax_reference(jnp.asarray(feats), jnp.asarray(idx))
    np.testing.assert_allclose(out, np.asarray(pallas), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_gather_mean_bf16_table_matches_jax():
    feats, idx = _inputs(8, 4, 16, seed=3, n=31)
    table = t(feats).to(torch.bfloat16)
    out = fused_gather_mean(table, t(idx))
    assert out.dtype == torch.float32
    pallas = jax_fused(jnp.asarray(feats).astype(jnp.bfloat16),
                       jnp.asarray(idx), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-2)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    feats, idx = _inputs(4, 3, 8, seed=1)
    monkeypatch.setattr(fused_gather_mean, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    fused_gather_mean(t(feats), t(idx))
    assert fused_gather_mean.launches == 0


def test_other_devices_raise_without_computing(monkeypatch):
    def no_plain(*a):
        raise AssertionError("only CPU tensors take the plain version")

    monkeypatch.setattr(gather, "gather_mean_reference", no_plain)
    feats = torch.zeros((5, 8), device="meta")
    idx = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather.fused_gather_mean(feats, idx)


@pytest.mark.parametrize("feats,idx,err", [
    (torch.zeros(5, 8), torch.zeros(2, 3, dtype=torch.int64), TypeError),
    (torch.zeros(5, 8, dtype=torch.float16),
     torch.zeros(2, 3, dtype=torch.int32), TypeError),
    (torch.zeros(8, 5).t(), torch.zeros(2, 3, dtype=torch.int32),
     ValueError),
    (torch.zeros(5, 8), torch.zeros(2, 0, dtype=torch.int32), ValueError),
    (torch.zeros(5, 8), torch.zeros(6, dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_bad_inputs(feats, idx, err):
    with pytest.raises(err):
        fused_gather_mean(feats, idx)


@pytest.mark.parametrize("F,elem,ptr,vec", [
    (602, 4, 0, 2), (640, 4, 0, 4), (3, 4, 0, 1), (602, 2, 0, 2),
    (640, 2, 0, 8), (640, 2, 8, 4), (640, 4, 4, 1),
])
def test_vector_width_divides_rows(F, elem, ptr, vec):
    assert gather._vector_width(F, elem, ptr, 0) == vec


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("gather_mean")
    assert not any(tmp_path.iterdir())


# ------------------------------------------------- K2: Philox dropout

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    words = philox.philox4x32([torch.tensor([c]) for c in counter], key)
    assert " ".join(f"{int(w[0]):08x}" for w in words) == want


def test_mulhilo_is_the_64bit_product():
    rng = np.random.default_rng(0)
    b = np.concatenate([rng.integers(0, 2**32, 1000), [0, 2**32 - 1]])
    for a in (philox.PHILOX_M0, philox.PHILOX_M1, 2**32 - 1):
        hi, lo = philox._mulhilo(a, torch.from_numpy(b))
        prod = [a * int(x) for x in b]
        assert hi.tolist() == [p >> 32 for p in prod]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


K2_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_126gather_mean_dropout_kernelIfLi2ELb0ELb1EEEvPKT_
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   IMAD.WIDE.U32 R2, R3, -0x2daee0ad, RZ ;  /* 0x0 */
        /*0010*/               @P0 BRA 0x0 ;                            /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_126gather_mean_dropout_kernelIfLi2ELb0ELb0EEEvPKT_
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x0 */
                                                                           /* 0x0 */
        /*0010*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;   /* 0x0 */
{body}
        /*0200*/               @P1 BRA 0x10 ;                           /* 0x0 */
        /*0210*/                   EXIT ;                                  /* 0x0 */
        /*0220*/                   BRA 0x220;                              /* 0x0 */
"""


def test_k2_sass_loop_per_element(monkeypatch):
    """chip_smoke.py's count of K2's inner loop from cuobjdump's text: the
    loop of the whole-row, 32-bit-counter f32 instance (not the wide one)
    that holds the Philox multiplies; two elements a LDG.E.64."""
    import chip_smoke

    body = "\n".join(
        f"        /*{0x20 + 16 * i:04x}*/                   {op} ;  /* 0x0 */"
        for i, op in enumerate(
            ["IMAD.WIDE.U32 R6, R7, -0x2daee0ad, RZ"] * 10
            + ["LOP3.LUT R8, R9, R10, R11, 0x96, !PT"] * 10
            + ["LDG.E.64.CONSTANT R12, desc[UR4][R4.64]"] * 2
            + ["@P2 FADD R13, R13, R12"] * 4))
    text = K2_SASS.format(body=body)
    functions = chip_smoke.sass_functions(text)
    assert len(functions) == 2
    loops = chip_smoke.sass_loops(
        functions[next(n for n in functions if "Lb0ELb0E" in n)])
    assert [(hex(a), hex(b)) for a, b, _ in loops] == [
        ("0x10", "0x200"), ("0x220", "0x220")]
    monkeypatch.setattr(chip_smoke, "sass_text", lambda path: text)
    got = chip_smoke.k2_loop_per_element("lib")
    # LDG, 10 + 10 + 2 + 4 body instructions and the branch
    assert got["instructions"] == 28 and got["elements"] == 4
    assert got["per_element"] == 7.0
    assert got["opcodes"]["IMAD.WIDE.U32"] == 10


def _ones_s1(n_rows=2048, F=64, seed=0):
    """An all-ones table and S=1 idx: the output is the mask times
    1/keep, element by element."""
    idx = np.random.default_rng(seed).integers(0, 32, (n_rows, 1),
                                               dtype=np.int32)
    return torch.ones(32, F), t(idx)


def test_dropout_plain_statistics():
    table, idx = _ones_s1()   # 131072 elements
    out = fused_gather_mean(table, idx, 0.4, seed=7, offset=(0, 0x5EED))
    assert abs(float((out == 0).float().mean()) - 0.4) < 0.02
    kept = out[out != 0]
    assert torch.equal(kept, torch.full_like(kept, np.float32(1 / 0.6)))


def test_dropout_plain_streams():
    """Deterministic for one (seed, step, tag); another seed, step or
    tag gives another mask; identical rows far apart differ."""
    table, idx = _ones_s1(n_rows=512)

    def mask(seed=7, step=3, tag=1, ids=idx):
        return fused_gather_mean(table, ids, 0.5, seed=seed,
                                 offset=(step, tag)) == 0

    base = mask()
    assert torch.equal(base, mask())
    for other in (mask(seed=8), mask(step=4), mask(tag=2),
                  mask(seed=7 + 2**32)):
        assert not torch.equal(base, other)
    same = mask(ids=torch.zeros(4096, 1, dtype=torch.int32))
    assert not torch.equal(same[:2048], same[2048:])


def test_dropout_plain_zero_rate_is_the_mean():
    feats, idx = _inputs(8, 5, 16, seed=2)
    out = fused_gather_mean(t(feats), t(idx), 0.0, seed=1, offset=(0, 0))
    assert torch.equal(out, gather_mean_reference(t(feats), t(idx)))
    assert torch.equal(
        philox.philox_dropout(t(feats), 0.0, 1, 0, 0), t(feats))


def test_dropout_plain_matches_jax_fallback_statistics():
    """The JAX package's fallback (tests/test_ops.py) on the same input:
    the same zero fraction up to sampling noise and the same 1/keep."""
    table, idx = _ones_s1()
    ours = fused_gather_mean(table, idx, 0.4, seed=7, offset=(0, 1)).numpy()
    theirs = np.asarray(jax_fused(jnp.asarray(table.numpy()),
                                  jnp.asarray(idx.numpy()), drop_rate=0.4,
                                  drop_key=jax.random.key(7)))
    assert abs((ours == 0).mean() - (theirs == 0).mean()) < 0.01
    np.testing.assert_allclose(ours[ours != 0], theirs[theirs != 0][0],
                               rtol=1e-6)


def test_dropout_plain_is_the_element_mask():
    """K2's plain version equals an explicit mask over [B*S, F] rows."""
    feats, idx = _inputs(6, 5, 13, seed=4)
    out = gather_mean_dropout_reference(t(feats), t(idx), 0.3, 5, (2, 9))
    keep = philox.dropout_keep_mask(30, 13, 0.3, 5, 2, 9).numpy()
    bits = philox.dropout_bits(30, 13, 5, 2, 9).numpy()
    assert np.array_equal(keep, bits < philox.dropout_threshold(0.3))
    rows = np.where(keep, feats[idx.reshape(-1)] * np.float32(1 / 0.7), 0)
    np.testing.assert_allclose(out.numpy(), rows.reshape(6, 5, 13).mean(1),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw,err", [
    (dict(drop_rate=0.5), "seed and offset"),
    (dict(drop_rate=0.5, seed=1), "seed and offset"),
    (dict(drop_rate=1.0, seed=1, offset=(0, 0)), "drop_rate"),
    (dict(drop_rate=-0.1), "drop_rate"),
    (dict(drop_rate=0.5, seed=-1, offset=(0, 0)), "seed"),
    (dict(drop_rate=0.5, seed=1, offset=(2**32, 0)), "step and tag"),
])
def test_dropout_wrapper_rejects_bad_streams(kw, err):
    feats, idx = _inputs(2, 2, 4, seed=0)
    with pytest.raises(ValueError, match=err):
        fused_gather_mean(t(feats), t(idx), **kw)


def test_cpu_dropout_takes_the_plain_version(monkeypatch):
    feats, idx = _inputs(4, 3, 8, seed=1)
    monkeypatch.setattr(fused_gather_mean, "dropout_launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    fused_gather_mean(t(feats), t(idx), 0.5, seed=3, offset=(0, 0))
    assert fused_gather_mean.dropout_launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gather_mean(torch.zeros((5, 8), device="meta"),
                          torch.zeros((2, 3), dtype=torch.int32,
                                      device="meta"),
                          0.5, seed=3, offset=(0, 0))


# ------------------------------------- K3: the deduplicating gather-mean

def _assert_compact_equal(idx):
    idx_u, n_u, w = dedup_compact(t(idx))
    j_idx_u, j_n_u, j_w = (np.asarray(a) for a in
                           jax_dedup_compact(jnp.asarray(idx)))
    np.testing.assert_array_equal(n_u.numpy(), j_n_u)
    np.testing.assert_array_equal(w.numpy(), j_w)
    for row, n in enumerate(j_n_u):
        np.testing.assert_array_equal(idx_u.numpy()[row, :n],
                                      j_idx_u[row, :n])


def test_dedup_compact_matches_jax_example():
    """tests/test_ops.py's example, exactly."""
    idx = np.array([[3, 1, 3, 3, 7], [2, 2, 2, 2, 2]], dtype=np.int32)
    _assert_compact_equal(idx)
    idx_u, n_u, w = dedup_compact(t(idx))
    assert n_u.tolist() == [3, 1] and n_u.dtype == torch.int32
    assert idx_u[0, :3].tolist() == [1, 3, 7] and idx_u[1, 0] == 2
    np.testing.assert_allclose(
        w.numpy(), [[0.2, 0.6, 0.2, 0, 0], [1, 0, 0, 0, 0]], rtol=1e-7)


@pytest.mark.parametrize("B,S,n", [(8, 5, 10), (13, 25, 10), (6, 7, 1000),
                                   (4, 1, 5), (5, 25, 2)])
def test_dedup_compact_matches_jax(B, S, n):
    """Random rows, from many repeats to all distinct: idx_u[:, :n_u],
    n_u and w exactly equal."""
    idx = np.random.default_rng(B * S + n).integers(0, n, (B, S),
                                                    dtype=np.int32)
    _assert_compact_equal(idx)


@pytest.mark.parametrize("B,S,F", [(8, 5, 16), (13, 25, 32)])
def test_gather_mean_dedup_matches_jax(B, S, F):
    """K3's plain version against the JAX dedup kernel in interpret mode,
    from a table of 10 rows (many duplicates), at tests/test_ops.py's
    rtol 1e-5, atol 1e-6; and against the plain mean."""
    rng = np.random.default_rng(B + S + F)
    feats = rng.standard_normal((10, F)).astype(np.float32)
    idx = rng.integers(0, 10, (B, S), dtype=np.int32)
    out = fused_gather_mean(t(feats), t(idx), dedup=True)
    assert out.dtype == torch.float32 and out.shape == (B, F)
    np.testing.assert_array_equal(
        out.numpy(), gather_mean_dedup_reference(t(feats), t(idx)).numpy())
    pallas = jax_fused(jnp.asarray(feats), jnp.asarray(idx), interpret=True,
                       dedup=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), gather_mean_reference(t(feats), t(idx)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_gather_mean_dedup_bf16_table_matches_jax():
    """A bf16 table: the rows are upcast exactly and summed in f32 on
    both sides, so the f32 tolerance holds."""
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((10, 16)).astype(np.float32)
    idx = rng.integers(0, 10, (8, 6), dtype=np.int32)
    out = fused_gather_mean(t(feats).to(torch.bfloat16), t(idx), dedup=True)
    pallas = jax_fused(jnp.asarray(feats, dtype=jnp.bfloat16),
                       jnp.asarray(idx), interpret=True, dedup=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_dedup_with_dropout_is_the_dropout_path():
    """Under dropout, dedup is ignored and K2's plain version runs with
    the same mask (tests/test_ops.py's rule: per-duplicate masks are
    inexpressible after deduplication)."""
    feats, idx = _inputs(8, 5, 16, seed=6, n=19)
    key = dict(seed=4, offset=(3, 0x5EED))
    a = fused_gather_mean(t(feats), t(idx), 0.3, dedup=True, **key)
    b = fused_gather_mean(t(feats), t(idx), 0.3, dedup=False, **key)
    assert torch.equal(a, b)


def test_dedup_sample_limit():
    """K3 keeps four words per sample in shared memory, so S is bounded
    by MAX_DEDUP_SAMPLES; K1 and K2 take more."""
    feats = torch.zeros(4, 2)
    idx = torch.zeros(1, MAX_DEDUP_SAMPLES + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(MAX_DEDUP_SAMPLES)):
        fused_gather_mean(feats, idx, dedup=True)
    fused_gather_mean(feats, idx)
    fused_gather_mean(feats, idx, 0.5, seed=1, offset=(0, 0), dedup=True)
    fused_gather_mean(feats, idx[:, :MAX_DEDUP_SAMPLES].contiguous(),
                      dedup=True)


def test_cpu_dedup_takes_the_plain_version(monkeypatch):
    feats, idx = _inputs(4, 3, 8, seed=1)
    monkeypatch.setattr(fused_gather_mean, "dedup_launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    fused_gather_mean(t(feats), t(idx), dedup=True)
    assert fused_gather_mean.dedup_launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gather_mean(torch.zeros((5, 8), device="meta"),
                          torch.zeros((2, 3), dtype=torch.int32,
                                      device="meta"), dedup=True)


# ------------------------------------------------- K4: the row gather

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F", [(8, 5, 16), (13, 25, 32), (33, 3, 10)])
def test_gather_rows_matches_jax(dtype, B, S, F):
    """K4's plain version is bit-equal to the JAX row kernel in interpret
    mode (B = 33 is off its 32-row tile), f32 and bf16."""
    feats, idx = _inputs(B, S, F, seed=B + S + F)
    table = t(feats).to(dtype)
    out = fused_gather_rows(table, t(idx))
    assert out.dtype == dtype and out.shape == (B * S, F)
    assert torch.equal(out, gather_rows_reference(table, t(idx)))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = jax_fused_rows(jnp.asarray(feats, dtype=jdtype),
                            jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(pallas).astype(np.float32))


def test_cpu_rows_take_the_plain_version(monkeypatch):
    """CPU tensors never build or count; other devices raise; S is not
    bounded by the gather-mean's shared memory."""
    monkeypatch.setattr(fused_gather_rows, "launches", 0)

    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the kernel")

    monkeypatch.setattr(build, "load", no_build)
    idx = torch.randint(0, 5, (2, gather.MAX_SAMPLES + 1), dtype=torch.int32)
    assert fused_gather_rows(torch.randn(5, 3), idx).shape == (
        2 * (gather.MAX_SAMPLES + 1), 3)
    assert fused_gather_rows.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gather_rows(torch.zeros((5, 8), device="meta"),
                          torch.zeros((2, 3), dtype=torch.int32,
                                      device="meta"))


@pytest.mark.parametrize("feats,idx,err", [
    (torch.zeros(5, 8), torch.zeros(2, 3, dtype=torch.int64), TypeError),
    (torch.zeros(5, 8, dtype=torch.float16),
     torch.zeros(2, 3, dtype=torch.int32), TypeError),
    (torch.zeros(8, 5).t(), torch.zeros(2, 3, dtype=torch.int32),
     ValueError),
    (torch.zeros(5, 8), torch.zeros(2, 0, dtype=torch.int32), ValueError),
    (torch.zeros(5, 8), torch.zeros(6, dtype=torch.int32), ValueError),
])
def test_rows_wrapper_rejects_bad_inputs(feats, idx, err):
    with pytest.raises(err):
        fused_gather_rows(feats, idx)


@pytest.mark.parametrize("row_bytes,feat_ptr,out_ptr,unit", [
    (2408, 0, 0, 8), (2560, 0, 0, 16), (1204, 0, 0, 4), (34, 0, 0, 2),
    (2560, 2408, 0, 8), (2560, 0, 4, 4), (4, 0, 0, 4),
])
def test_copy_width_divides_rows(row_bytes, feat_ptr, out_ptr, unit):
    assert gather._copy_width(row_bytes, feat_ptr, out_ptr) == unit
