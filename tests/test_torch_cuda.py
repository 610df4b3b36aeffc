"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. On a machine
with a card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which neither the
port nor these tests need.)
"""

import numpy as np
import pytest
import torch

from graphsage_tpu_torch.ops.gather import (
    fused_gather_mean,
    gather_mean_dropout_reference,
    gather_mean_reference,
)

pytestmark = pytest.mark.cuda

TOLERANCES = {  # kernel vs plain version, both accumulating in f32
    torch.float32: dict(rtol=1e-5, atol=1e-6),
    torch.bfloat16: dict(rtol=2e-2, atol=1e-6),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F", [
    (1, 1, 1), (1, 1, 3), (4, 3, 602), (9, 25, 640), (33, 10, 17),
    (2, 7, 1032), (300, 25, 602),
])
def test_kernel_matches_plain(cuda, dtype, B, S, F):
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + S * 10 + F)
    n = 50
    table = torch.randn(n + 1, F, generator=gen, device=cuda).to(dtype)
    table[n] = 0
    idx = torch.randint(0, n + 1, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[0] = n  # the dummy row
    before = fused_gather_mean.launches
    out = fused_gather_mean(table, idx)
    torch.cuda.synchronize()
    assert fused_gather_mean.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, F)
    assert (out[0] == 0).all()
    torch.testing.assert_close(out, gather_mean_reference(table, idx),
                               **TOLERANCES[dtype])


def test_kernel_row_offsets_beyond_int32(cuda):
    """idx * F exceeds 2**31 here: the kernel's offsets are 64-bit."""
    F, n_rows = 602, 3_600_000
    table = torch.zeros(n_rows, F, dtype=torch.bfloat16, device=cuda)
    rows = torch.tensor([0, 3_000_000, n_rows - 1], device=cuda)
    table[rows] = torch.arange(1, 4, device=cuda, dtype=torch.bfloat16)[:,
                                                                         None]
    idx = rows.to(torch.int32).view(1, 3)
    out = fused_gather_mean(table, idx)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), 2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F", [
    (1, 1, 1), (1, 1, 3), (4, 3, 602), (9, 25, 640), (33, 10, 17),
    (2, 7, 1032), (300, 25, 602),
])
def test_dropout_kernel_matches_plain(cuda, dtype, B, S, F):
    """K2 draws the plain version's Philox bits: identical masks (seen
    through S=1 on a table without zeros), means within f32 rounding
    (both sum the same f32 products, in another order)."""
    gen = torch.Generator(device=cuda).manual_seed(B * 1000 + S * 10 + F)
    table = (torch.rand(51, F, generator=gen, device=cuda) + 0.5).to(dtype)
    idx = torch.randint(0, 51, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    key = dict(seed=2**63 + 12345, offset=(7, 0x5EED))
    before = fused_gather_mean.dropout_launches
    out = fused_gather_mean(table, idx, 0.5, **key)
    torch.cuda.synchronize()
    assert fused_gather_mean.dropout_launches == before + 1
    torch.testing.assert_close(
        out, gather_mean_dropout_reference(table, idx, 0.5, **key),
        rtol=1e-5, atol=1e-6)
    flat = idx.reshape(-1, 1).contiguous()
    got = fused_gather_mean(table, flat, 0.5, **key)
    want = gather_mean_dropout_reference(table, flat, 0.5, **key)
    assert torch.equal(got == 0, want == 0)


def test_dropout_kernel_statistics(cuda):
    """Zero fraction, exact 1/keep scale, determinism, a new mask per
    step, and different masks for identical rows far apart."""
    table = torch.ones(64, 602, device=cuda)
    idx = torch.randint(0, 64, (4096, 1), device=cuda, dtype=torch.int32)
    out = fused_gather_mean(table, idx, 0.4, seed=11, offset=(0, 1))
    assert abs(float((out == 0).float().mean()) - 0.4) < 0.005
    kept = out[out != 0]
    assert torch.equal(kept, torch.full_like(kept, 1.0 / 0.6))
    again = fused_gather_mean(table, idx, 0.4, seed=11, offset=(0, 1))
    assert torch.equal(out, again)
    other = fused_gather_mean(table, idx, 0.4, seed=11, offset=(1, 1))
    assert not torch.equal(out == 0, other == 0)
    same_rows = fused_gather_mean(table, torch.zeros_like(idx), 0.4,
                                  seed=11, offset=(0, 1))
    assert not torch.equal(same_rows[:2048] == 0, same_rows[2048:] == 0)


def test_zero_rate_launches_k1(cuda):
    table = torch.randn(10, 8, device=cuda)
    idx = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    k1, k2 = fused_gather_mean.launches, fused_gather_mean.dropout_launches
    out = fused_gather_mean(table, idx, 0.0)
    assert (fused_gather_mean.launches, fused_gather_mean.dropout_launches) \
        == (k1 + 1, k2)
    torch.testing.assert_close(out, gather_mean_reference(table, idx))
