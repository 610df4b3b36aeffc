"""The numerical design of K5/K6 (graphsage_tpu_torch/ops/csrc/
gather_mlp_pool.cu) on the CPU: the kernels run their product on the
tensor cores as 3xTF32, and ``ops/pool.py::tf32_split`` states the split.

An emulation of that product (each part's products exact in f32, summed
in f32, as the tensor cores do) is held against the JAX package's
``gather_mlp_pool_reference`` (f32, "highest" precision) within
chip_smoke.py's POOL_TOL, the limit K5/K6 meet against their plain
versions on the card. A single TF32 pass misses it: that is why the
kernels issue three products (two for a bf16 table, whose rows are exact
in TF32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.ops import pool as jpool
from graphsage_tpu_torch.ops.pool import tf32_split

POOL_TOL = 5e-5          # chip_smoke.py: K5/K6 against their plain versions
B, S, F, H = 40, 25, 602, 512
N = 200


def _mantissa_tail(x: torch.Tensor) -> torch.Tensor:
    """The low 13 bits of each f32 bit pattern: zero for a TF32 value."""
    return x.view(torch.int32) & 0x1FFF


def test_tf32_split_hi_has_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert int((_mantissa_tail(hi) != 0).sum()) == 0
    assert int((_mantissa_tail(lo) != 0).sum()) == 0
    # round to nearest: hi is within half a TF32 ulp (2^-11 relative)
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


def test_tf32_split_of_bf16_is_exact():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)
                         ).to(torch.bfloat16)
    hi, lo = tf32_split(x)
    assert torch.equal(hi, x.float())
    assert int((lo != 0).sum()) == 0


def test_tf32_split_reconstructs_f32():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-20, 20, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21


@pytest.fixture(scope="module")
def operands():
    """A table with a zero dummy row and an all-negative row, glorot w,
    small bias, [B, S] ids, as chip_smoke.py's pool_operands."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((N + 1, F)).astype(np.float32)
    table[N] = 0
    table[11] = -np.abs(table[11]) - 1.0
    limit = np.sqrt(6.0 / (F + H))
    w = rng.uniform(-limit, limit, (F, H)).astype(np.float32)
    b = (rng.standard_normal(H) * 0.1).astype(np.float32)
    idx = rng.integers(0, N + 1, (B, S)).astype(np.int32)
    return table, w, b, idx


def _pool_tf32(rows: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               reduce: str, passes: int) -> torch.Tensor:
    """reduce_s relu(rows @ w + b) with the product in TF32 parts:
    passes 3 sums hi*hi + hi*lo + lo*hi, 2 (a bf16 table) rows*hi +
    rows*lo, 1 hi*hi alone. Each part's products are exact in f32."""
    r_hi, r_lo = tf32_split(rows)
    w_hi, w_lo = tf32_split(w)
    if passes == 3:
        z = r_hi @ w_lo + r_lo @ w_hi + r_hi @ w_hi
    elif passes == 2:
        z = r_hi @ w_lo + r_hi @ w_hi
    else:
        z = r_hi @ w_hi
    h = torch.relu(z + b).view(-1, S, w.shape[1])
    return torch.amax(h, dim=1) if reduce == "max" else h.mean(dim=1)


def _jax_reference(table, idx, w, b, reduce):
    return np.asarray(jpool.gather_mlp_pool_reference(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(b), reduce))


@pytest.mark.parametrize("reduce", ["mean", "max"])
@pytest.mark.parametrize("table_dtype,passes", [
    (torch.float32, 3), (torch.bfloat16, 2),
])
def test_tf32_passes_meet_the_pool_tolerance(operands, reduce, table_dtype,
                                             passes):
    """3xTF32 (f32 table) and 2xTF32 (bf16 table) against the JAX f32
    reference at the hop's widths F = 602, H = 512."""
    table, w, b, idx = operands
    tab = torch.from_numpy(table).to(table_dtype)
    want = _jax_reference(tab.float().numpy(), idx, w, b, reduce)
    rows = tab.index_select(0, torch.from_numpy(idx).reshape(-1).long())
    got = _pool_tf32(rows.float(), torch.from_numpy(w), torch.from_numpy(b),
                     reduce, passes)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POOL_TOL)


def test_single_tf32_pass_misses_the_pool_tolerance(operands):
    """One TF32 product is ~4x off the limit: the kernels do not take
    it."""
    table, w, b, idx = operands
    want = _jax_reference(table, idx, w, b, "mean")
    rows = torch.from_numpy(table).index_select(
        0, torch.from_numpy(idx).reshape(-1).long())
    got = _pool_tf32(rows, torch.from_numpy(w), torch.from_numpy(b), "mean",
                     1)
    assert float(np.abs(got.numpy() - want).max()) > POOL_TOL
