"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. On a machine
with a card, from the root of the checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which neither the
port nor these tests need.)
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphsage_tpu_torch.ops.gather import (
    MAX_DEDUP_SAMPLES,
    MAX_SAMPLES,
    fused_gather_mean,
    fused_gather_rows,
    gather_mean_dedup_reference,
    gather_mean_dropout_reference,
    gather_mean_reference,
    gather_rows_reference,
)
from graphsage_tpu_torch.ops import gather_probe as probe_ops
from graphsage_tpu_torch.ops.gather_probe import (
    cold_first_topk,
    coldsw_reference,
    hotcount_reference,
    hotmx_reference,
    probe_coldsw,
    probe_gather,
    probe_gather_hot,
    probe_hotcount,
    probe_hotmx,
)
from graphsage_tpu_torch import trace
from graphsage_tpu_torch.ops.philox import dropout_keep_mask
from graphsage_tpu_torch.ops.pool import (
    fused_gather_mlp_pool,
    gather_mlp_pool_reference,
    gather_mlp_pool_train,
    gather_mlp_pool_with_rows,
    gathered_rows_reference,
    pool_rows,
)

pytestmark = pytest.mark.cuda

TOLERANCES = {  # kernel vs plain version, both accumulating in f32
    torch.float32: dict(rtol=1e-5, atol=1e-6),
    # the same bf16-exact values, summed in f32 in the same order
    torch.bfloat16: dict(rtol=0, atol=1e-5),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F", [
    (1, 1, 1), (1, 1, 3), (4, 3, 602), (9, 25, 640), (33, 10, 17),
    (2, 7, 1032), (300, 25, 602), (2, MAX_SAMPLES, 33),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,n_blocks", [(602, 2), (602, 4), (13, 2),
                                        (10, 3)])
def test_dropout_kernel_on_column_blocks(cuda, dtype, F, n_blocks):
    """K2 on a rank's column block under tensor parallelism
    (``parallel/tensor.py::column_blocks``: 304 + 298 columns of 602 at
    M = 2, a last block 5 or 2 wide): the plain version's mask at the
    block's columns (``col_base``, ``row_width``), which is the whole
    rows' mask there, bit for bit; the means within f32 rounding."""
    from graphsage_tpu_torch.parallel.tensor import column_blocks

    gen = torch.Generator(device=cuda).manual_seed(F * 10 + n_blocks)
    table = (torch.rand(51, F, generator=gen, device=cuda) + 0.5).to(dtype)
    idx = torch.randint(0, 51, (40, 9), generator=gen, device=cuda,
                        dtype=torch.int32)
    flat = idx.reshape(-1, 1).contiguous()
    key = dict(seed=2**63 + 12345, offset=(7, 0x5EED))
    whole = fused_gather_mean(table, flat, 0.5, **key) == 0
    for lo, hi in column_blocks(F, n_blocks):
        block = table[:, lo:hi].contiguous()
        blk = dict(col_base=lo, row_width=F)
        out = fused_gather_mean(block, idx, 0.5, **key, **blk)
        torch.testing.assert_close(
            out, gather_mean_dropout_reference(block, idx, 0.5, key["seed"],
                                               key["offset"], lo, F),
            rtol=1e-5, atol=1e-6)
        got = fused_gather_mean(block, flat, 0.5, **key, **blk) == 0
        assert torch.equal(got, whole[:, lo:hi])


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


K2_KEY = dict(seed=2**63 + 12345, offset=(7, 0x5EED))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 25, 64])
@pytest.mark.parametrize("F", [1, 3, 5, 8, 601, 602, 640])
def test_dropout_kernel_mask_is_the_plain_mask(cuda, dtype, S, F):
    """K2's mask bit for bit against ``philox.dropout_keep_mask`` (through
    S = 1 on a table without zeros: a row's element is nonzero iff it is
    kept), the means within 1e-5 of the plain version; B = 37 rows, a
    launch's items ragged over its blocks whatever F."""
    B = 37
    gen = torch.Generator(device=cuda).manual_seed(F * 100 + S)
    table = (torch.rand(51, F, generator=gen, device=cuda) + 0.5).to(dtype)
    idx = torch.randint(0, 51, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    out = fused_gather_mean(table, idx, 0.5, **K2_KEY)
    want = gather_mean_dropout_reference(table, idx, 0.5, **K2_KEY)
    assert float((out - want).abs().max()) <= 1e-5
    flat = idx.reshape(-1, 1).contiguous()
    kept = fused_gather_mean(table, flat, 0.5, **K2_KEY) != 0
    mask = dropout_keep_mask(B * S, F, 0.5, K2_KEY["seed"],
                             *K2_KEY["offset"], device=cuda)
    assert torch.equal(kept, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 17, 18, 19, 20])
@pytest.mark.parametrize("F,n_blocks", [(5, 1), (602, 1), (640, 1),
                                        (602, 2), (602, 4)])
def test_dropout_kernel_mask_sample_by_sample(cuda, dtype, S, F, n_blocks):
    """K2's mask for every sample, bit for bit against
    ``philox.dropout_keep_mask``, through its loop over samples: row s of
    the table is 2**s and idx[b, s] = s, so out * S / scale is the integer
    whose bit s says whether sample s was kept (exact in f32 up to S =
    20). S 16 to 20 run the loop four samples at a time (f32, and bf16
    at VEC <= 4) or two (bf16 at VEC 8: F = 640 and the 304- and
    152-column blocks), then every tail; on each column block of
    ``column_blocks(F, n_blocks)`` too, at its columns of the whole
    rows' mask; B = 37."""
    from graphsage_tpu_torch.ops.philox import dropout_scale
    from graphsage_tpu_torch.parallel.tensor import column_blocks

    B = 37
    idx = torch.arange(S, dtype=torch.int32, device=cuda).expand(
        B, S).contiguous()
    for lo, hi in column_blocks(F, n_blocks):
        blk = {} if n_blocks == 1 else dict(col_base=lo, row_width=F)
        table = (2.0 ** torch.arange(S, dtype=torch.float64, device=cuda))[
            :, None].expand(S, hi - lo).to(dtype).contiguous()
        out = fused_gather_mean(table, idx, 0.5, **K2_KEY, **blk)
        sums = torch.round(out.double() * S / dropout_scale(0.5)).long()
        assert not bool((sums >> S).any())
        kept = ((sums[:, None, :]
                 >> torch.arange(S, device=cuda)[None, :, None]) & 1).bool()
        mask = dropout_keep_mask(B * S, hi - lo, 0.5, K2_KEY["seed"],
                                 *K2_KEY["offset"], device=cuda, **blk)
        assert torch.equal(kept, mask.view(B, S, hi - lo))


def test_dropout_kernel_64bit_counters(cuda):
    """The first columns of rows 2**33 wide: B x S x row_groups passes
    2**32, so the counters are 64-bit (the kernel's wide instance); the
    mask is the plain version's there too."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    table = torch.rand(51, 12, generator=gen, device=cuda) + 0.5
    idx = torch.randint(0, 51, (40, 3), generator=gen, device=cuda,
                        dtype=torch.int32)
    blk = dict(col_base=0, row_width=2**33)
    out = fused_gather_mean(table, idx, 0.5, **K2_KEY, **blk)
    want = gather_mean_dropout_reference(table, idx, 0.5, K2_KEY["seed"],
                                         K2_KEY["offset"], **blk)
    assert float((out - want).abs().max()) <= 1e-5
    flat = idx.reshape(-1, 1).contiguous()
    kept = fused_gather_mean(table, flat, 0.5, **K2_KEY, **blk) != 0
    assert torch.equal(kept, dropout_keep_mask(
        120, 12, 0.5, K2_KEY["seed"], *K2_KEY["offset"], device=cuda,
        **blk))


def test_dropout_kernel_row_offsets_beyond_int32(cuda):
    """idx * F exceeds 2**31 here: K2's row offsets are 64-bit."""
    F, n_rows = 602, 3_600_000
    table = torch.zeros(n_rows, F, dtype=torch.bfloat16, device=cuda)
    rows = torch.tensor([0, 3_000_000, n_rows - 1], device=cuda)
    table[rows] = torch.arange(1, 4, device=cuda, dtype=torch.bfloat16)[:,
                                                                         None]
    idx = rows.to(torch.int32).view(1, 3)
    out = fused_gather_mean(table, idx, 0.5, **K2_KEY)
    want = gather_mean_dropout_reference(table, idx, 0.5, **K2_KEY)
    assert float((out - want).abs().max()) <= 1e-5 and bool(out.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_repeats_bit_for_bit(cuda, dtype):
    table = torch.randn(3000, 602, device=cuda).to(dtype)
    idx = torch.randint(0, 3000, (700, 25), device=cuda, dtype=torch.int32)
    assert torch.equal(fused_gather_mean(table, idx, 0.5, **K2_KEY),
                       fused_gather_mean(table, idx, 0.5, **K2_KEY))


K2_TRAP = """
import torch
from graphsage_tpu_torch.ops.gather import fused_gather_mean
dev = torch.device("cuda")
table = torch.zeros(11, 602, device=dev)
idx = torch.full((64, 25), 2, dtype=torch.int32, device=dev)
idx[37, 3] = {bad}
fused_gather_mean(table, idx, 0.5, seed=1, offset=(0, 1))
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("bad", [11, -1])
def test_dropout_kernel_out_of_range_id_traps(cuda, bad):
    """An id outside [0, N) stops K2 (in a process of its own: a trap ends
    the CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", K2_TRAP.format(bad=bad)],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode != 0 and "NO TRAP" not in proc.stdout


# ------------------------------------------------------------------ K3

def _dedup_idx(cuda, kind, B, S, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if kind == "equal":        # one distinct sample per row
        return torch.randint(0, n, (B, 1), generator=gen, device=cuda,
                             dtype=torch.int32).expand(B, S).contiguous()
    if kind == "distinct":     # no repeats within a row
        return torch.stack([torch.randperm(n, generator=gen, device=cuda)[:S]
                            for _ in range(B)]).to(torch.int32)
    return torch.randint(0, n, (B, S), generator=gen, device=cuda,
                         dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F,kind", [
    (1, 1, 1, "random"), (7, 25, 602, "random"), (9, 25, 17, "random"),
    (5, 25, 602, "equal"), (5, 25, 640, "distinct"), (300, 25, 602, "random"),
    (3, MAX_DEDUP_SAMPLES, 33, "random"),
])
def test_dedup_kernel_matches_plain(cuda, dtype, B, S, F, kind):
    """K3 at ragged shapes against its plain version (both sum w * row
    in f32, in another order) and against K1's mean."""
    n = 4000 if kind == "distinct" or S > 100 else 40
    table = torch.randn(n, F, generator=torch.Generator(
        device=cuda).manual_seed(F), device=cuda).to(dtype)
    idx = _dedup_idx(cuda, kind, B, S, n, seed=B + S)
    before = fused_gather_mean.dedup_launches
    out = fused_gather_mean(table, idx, dedup=True)
    torch.cuda.synchronize()
    assert fused_gather_mean.dedup_launches == before + 1
    torch.testing.assert_close(
        out, gather_mean_dedup_reference(table, idx), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, gather_mean_reference(table, idx),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(out, fused_gather_mean(table, idx, dedup=True))


def test_dedup_with_dropout_launches_k2(cuda):
    table = torch.randn(30, 64, device=cuda)
    idx = torch.randint(0, 30, (16, 5), device=cuda, dtype=torch.int32)
    k2, k3 = fused_gather_mean.dropout_launches, \
        fused_gather_mean.dedup_launches
    a = fused_gather_mean(table, idx, 0.5, seed=3, offset=(1, 2), dedup=True)
    b = fused_gather_mean(table, idx, 0.5, seed=3, offset=(1, 2))
    assert torch.equal(a, b)
    assert (fused_gather_mean.dropout_launches,
            fused_gather_mean.dedup_launches) == (k2 + 2, k3)


# ------------------------------------------------- K1 and K3 at their edges

def _hop_like_idx(rng, n, batch=64, fanouts=(10, 25), degree=32):
    """[batch * 10, 25] ids as the sampler's shared_perm draws the
    innermost hop over a zipf adjacency: hubs in most rows, and a hop
    node drawn k times gives k identical rows, spread over the idx."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.05
    adj = rng.choice(n, (n, degree), p=p / p.sum())
    hop = adj[rng.choice(n, batch, replace=False)]
    hop = hop[:, rng.permutation(degree)[:fanouts[0]]]
    return adj[hop.reshape(-1)][:, rng.permutation(degree)[:fanouts[1]]]


def _edge_idx(cuda, kind, B, S, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "hop":
        ids = _hop_like_idx(rng, n)
    elif kind == "equal":        # one distinct sample per row
        ids = np.repeat(rng.integers(0, n, (B, 1)), S, axis=1)
    elif kind == "distinct":     # no repeats within a row
        ids = np.stack([rng.permutation(n)[:S] for _ in range(B)])
    elif kind == "repeated":     # 7 rows, each repeated down the idx
        ids = rng.integers(0, n, (7, S))[np.arange(B) % 7]
    else:
        ids = rng.integers(0, n, (B, S))
    return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(
        cuda)


EDGE_CASES = [  # B, S, F, kind; B not a multiple of 32
    (33, 1, 602, "random"), (47, 31, 602, "random"), (40, 32, 640, "random"),
    (40, 33, 17, "random"), (65, 25, 1, "random"), (70, 25, 17, "repeated"),
    (64, 25, 602, "equal"), (64, 25, 640, "distinct"), (640, 25, 602, "hop"),
    (3, MAX_DEDUP_SAMPLES, 33, "random"),
]


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F,kind", EDGE_CASES)
def test_k1_k3_match_plain_at_edges(cuda, dedup, dtype, B, S, F, kind):
    """K1 and K3 at their edges against their plain versions: both sum
    the same f32 (or bf16-exact) values in f32."""
    n = 4000
    gen = torch.Generator(device=cuda).manual_seed(F + S)
    table = torch.randn(n, F, generator=gen, device=cuda).to(dtype)
    idx = _edge_idx(cuda, kind, B, S, n, seed=B * S)
    counter = "dedup_launches" if dedup else "launches"
    before = getattr(fused_gather_mean, counter)
    out = fused_gather_mean(table, idx, dedup=dedup)
    torch.cuda.synchronize()
    assert getattr(fused_gather_mean, counter) == before + 1
    plain = gather_mean_dedup_reference if dedup else gather_mean_reference
    torch.testing.assert_close(out, plain(table, idx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k3_unaligned_table(cuda, dedup, dtype):
    """A table one element off a whole load takes one-element loads and
    gives its plain version's result, as the aligned table does."""
    base = torch.randn(301 * 602 + 2, device=cuda).to(dtype)
    idx = _edge_idx(cuda, "hop", 0, 0, 300, seed=5)
    plain = gather_mean_dedup_reference if dedup else gather_mean_reference
    for table in (base[1:-1].view(301, 602), base[:-2].view(301, 602)):
        torch.testing.assert_close(fused_gather_mean(table, idx, dedup=dedup),
                                   plain(table, idx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k3_repeat_bit_for_bit(cuda, dedup, dtype):
    """No float atomics: each output element is summed in one fixed
    order."""
    table = torch.randn(3000, 602, device=cuda).to(dtype)
    idx = _edge_idx(cuda, "hop", 0, 0, 3000, seed=7)
    first = fused_gather_mean(table, idx, dedup=dedup)
    for _ in range(3):
        assert torch.equal(first, fused_gather_mean(table, idx, dedup=dedup))


def test_k3_matches_k1_on_hop_like_idx(cuda):
    table = torch.randn(3000, 602, device=cuda)
    idx = _edge_idx(cuda, "hop", 0, 0, 3000, seed=8)
    torch.testing.assert_close(fused_gather_mean(table, idx, dedup=True),
                               fused_gather_mean(table, idx), rtol=0,
                               atol=1e-5)


EDGE_TRAP = """
import torch
from graphsage_tpu_torch.ops.gather import fused_gather_mean
dev = torch.device("cuda")
table = torch.zeros(11, 602, device=dev)
idx = torch.full((64, 25), 2, dtype=torch.int32, device=dev)
idx[37, 3] = {bad}
fused_gather_mean(table, idx, dedup={dedup})
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("bad", [11, -1])
def test_k1_k3_out_of_range_id_traps(cuda, dedup, bad):
    """An id outside [0, N) stops the kernel (in a process of its own:
    a trap ends the CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", EDGE_TRAP.format(bad=bad, dedup=dedup)],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode != 0 and "NO TRAP" not in proc.stdout


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,F", [
    (1, 1, 1), (7, 25, 602), (9, 10, 17), (33, 1, 640), (2, 3, 8),
    (512, 25, 602),
])
def test_rows_kernel_is_index_select(cuda, dtype, B, S, F):
    """K4 is bit-equal to index_select at ragged shapes (odd F gives
    2-byte bf16 copies, F = 602 f32 8-byte ones, F = 640 16-byte ones)."""
    gen = torch.Generator(device=cuda).manual_seed(B + S + F)
    table = torch.randn(61, F, generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, 61, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = fused_gather_rows.launches
    out = fused_gather_rows(table, idx)
    torch.cuda.synchronize()
    assert fused_gather_rows.launches == before + 1
    assert out.dtype == dtype and out.shape == (B * S, F)
    assert torch.equal(out, gather_rows_reference(table, idx))


def test_rows_kernel_unaligned_table(cuda):
    """A table starting 8 bytes off a 16-byte boundary takes narrower
    copies and the same result."""
    base = torch.randn(41 * 640 + 2, device=cuda)
    table = base[2:].view(41, 640)
    idx = torch.randint(0, 41, (6, 4), device=cuda, dtype=torch.int32)
    assert torch.equal(fused_gather_rows(table, idx),
                       gather_rows_reference(table, idx))


# K5/K6 vs plain: z sums F products in another order than cuBLAS
POOL_TOLERANCE = dict(rtol=1e-5, atol=5e-5)
# K6's stated error on z: relu's mask may differ from the plain z > 0
# only where |z| is below it
RELU_Z_TOL = 1.6e-5


def _pool_operands(cuda, seed, n, F, H, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    table = torch.randn(n + 1, F, generator=gen, device=cuda)
    table[n] = 0
    table[min(7, n)] = table[min(3, n)]   # max ties
    w = torch.randn(F, H, generator=gen, device=cuda) / F ** 0.5
    b = torch.randn(H, generator=gen, device=cuda) * 0.1
    return table.to(dtype), w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["mean", "max"])
@pytest.mark.parametrize("B,S,F,H", [
    (1, 1, 1, 1), (7, 25, 602, 512), (33, 1, 17, 24), (9, 10, 17, 24),
    (3, 200, 33, 130), (130, 25, 602, 512), (5, 25, 8, 256),
    (11, 25, 602, 130), (23, 12, 602, 24), (257, 1, 17, 256),
    (3, 300, 8, 24), (2, 200, 602, 256), (0, 25, 602, 512),
])
def test_pool_kernel_matches_plain(cuda, dtype, reduce, B, S, F, H):
    """K5 at ragged shapes: S=1, F off the 8-column stage (17, 602) and
    on it (8), H off the 128-column tile (24, 130) and two tiles (256),
    B*S off the block's 256 rows, S beyond them (300, one row a block in
    chunks), B = 0, max ties."""
    table, w, b = _pool_operands(cuda, B + S + F + H, 50, F, H, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S)
    idx = torch.randint(0, 51, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    if B:
        idx[0] = 3
    before = fused_gather_mlp_pool.launches
    out = fused_gather_mlp_pool(table, idx, w, b, reduce)
    torch.cuda.synchronize()
    assert fused_gather_mlp_pool.launches == before + 1
    torch.testing.assert_close(
        out, gather_mlp_pool_reference(table, idx, w, b, reduce),
        **POOL_TOLERANCE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_residual_is_the_plain_dropped_rows(cuda, dtype):
    """K6's residual equals the plain dropped rows bit for bit (so its
    mask is dropout_keep_mask's), the pooled output is pool(relu(X@w+b))."""
    table, w, b = _pool_operands(cuda, 4, 80, 602, 512, dtype)
    idx = torch.randint(0, 80, (300, 25), device=cuda, dtype=torch.int32)
    key = dict(seed=2**63 + 12345, offset=(7, 0x5EED))
    before = fused_gather_mlp_pool.train_launches
    out, x, _ = gather_mlp_pool_with_rows(table, idx, w, b, "mean", 0.5,
                                          **key)
    torch.cuda.synchronize()
    assert fused_gather_mlp_pool.train_launches == before + 1
    x_ref = gathered_rows_reference(table, idx, 0.5, **key)
    assert torch.equal(x, x_ref)
    keep = dropout_keep_mask(300 * 25, 602, 0.5, key["seed"], *key["offset"],
                             device=cuda)
    assert torch.equal(x != 0, keep & (gathered_rows_reference(table, idx)
                                       != 0))
    torch.testing.assert_close(out, pool_rows(x_ref, w, b, "mean", 25),
                               **POOL_TOLERANCE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_pool_kernel_repeats_bit_for_bit(cuda, dtype, reduce):
    """No float atomics: two launches on the same inputs give the same
    bits, for K5 and for K6 (pooled output, residual and relu's mask)."""
    table, w, b = _pool_operands(cuda, 6, 80, 602, 512, dtype)
    idx = torch.randint(0, 81, (130, 25), device=cuda, dtype=torch.int32)
    first = fused_gather_mlp_pool(table, idx, w, b, reduce)
    assert torch.equal(first, fused_gather_mlp_pool(table, idx, w, b,
                                                    reduce))
    key = dict(seed=5, offset=(3, 4))
    out, x, mask = gather_mlp_pool_with_rows(table, idx, w, b, reduce, 0.5,
                                             **key)
    out2, x2, mask2 = gather_mlp_pool_with_rows(table, idx, w, b, reduce,
                                                0.5, **key)
    assert torch.equal(out, out2) and torch.equal(x, x2)
    assert torch.equal(mask, mask2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduce,rate", [("mean", 0.0), ("max", 0.5)])
@pytest.mark.parametrize("B,S,F,H", [
    (1, 1, 1, 1), (7, 25, 602, 512), (9, 10, 17, 24), (11, 25, 602, 130),
    (257, 1, 17, 256), (3, 300, 8, 24), (2, 200, 602, 256), (0, 25, 602, 512),
])
def test_pool_relu_mask_is_the_plain_sign(cuda, dtype, reduce, rate, B, S,
                                          F, H):
    """K6's relu mask is (plain rows @ w + b) > 0 at every element but
    those whose |z| lies within K6's error of zero, at ragged shapes:
    H off the 128-column tile, S beyond a block's 256 rows, B = 0."""
    table, w, b = _pool_operands(cuda, B + S + F + H + 1, 50, F, H, dtype)
    gen = torch.Generator(device=cuda).manual_seed(S + 1)
    idx = torch.randint(0, 51, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    key = dict(seed=2**40 + 3, offset=(5, 6)) if rate else {}
    _, x, mask = gather_mlp_pool_with_rows(table, idx, w, b, reduce, rate,
                                           **key)
    z = gathered_rows_reference(table, idx, rate, **key) @ w + b
    assert mask.shape == (B * S, H) and mask.dtype == torch.bool
    flips = mask != (z > 0)
    print(f"relu mask [{B * S}, {H}]: {int(flips.sum())} of {mask.numel()} "
          f"differ from the plain z > 0")
    assert bool((z[flips].abs() < RELU_Z_TOL).all())


@pytest.mark.parametrize("reduce", ["mean", "max"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_pool_train_grads_match_autograd(cuda, reduce, rate):
    """The Function (K6 forward, route_pool_grad backward: the mean's
    from K6's relu mask, the max's recomputing z) against autograd of the
    plain composition, max ties included; under no_grad it launches K5.
    rtol 1e-4, atol 1e-5 as tests/test_pool.py."""
    table, w, b = _pool_operands(cuda, 5, 60, 96, 160)
    idx = torch.randint(0, 61, (40, 10), device=cuda, dtype=torch.int32)
    idx[0] = 3
    idx[1, :2] = torch.tensor([3, 7], device=cuda)
    key = dict(seed=99, offset=(1, 2)) if rate else {}
    cot = torch.randn(40, 160, device=cuda)
    w1, b1 = w.clone().requires_grad_(), b.clone().requires_grad_()
    before = trace.snapshot()
    (gather_mlp_pool_train(table, idx, w1, b1, reduce, rate, **key)
     * cot).sum().backward()
    after = trace.snapshot()
    route = "pool_grad_mask" if reduce == "mean" else "pool_grad_recompute"
    assert {k: after[k] - before[k] for k in
            ("pool_grad_mask", "pool_grad_recompute")} == {
        "pool_grad_mask": 0, "pool_grad_recompute": 0, route: 1}
    w2, b2 = w.clone().requires_grad_(), b.clone().requires_grad_()
    (pool_rows(gathered_rows_reference(table, idx, rate, **key), w2, b2,
               reduce, 10) * cot).sum().backward()
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(b1.grad, b2.grad, rtol=1e-4, atol=1e-5)
    k5 = fused_gather_mlp_pool.launches
    with torch.no_grad():
        gather_mlp_pool_train(table, idx, w1, b1, reduce, rate, **key)
    assert fused_gather_mlp_pool.launches == k5 + 1


# ------------------------------------------------ K7: the probe kernels

PROBE_TOL = dict(rtol=0, atol=1e-5)  # max abs error, K7 vs plain


def _probe_operands(cuda, B, S, F, n, dtype=torch.float32, seed=0):
    """A table of n rows and the zero dummy row n; ids over all n + 1
    rows with row 0 all dummy, row 1 all below 4 and, where there are
    rows enough, row 2 all at least n - 4."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    table = torch.randn(n + 1, F, generator=gen, device=cuda).to(dtype)
    table[n] = 0
    idx = torch.randint(0, n + 1, (B, S), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[0] = n
    if B > 1:
        idx[1] = torch.randint(0, 4, (S,), generator=gen, device=cuda,
                               dtype=torch.int32)
    if B > 2:
        idx[2] = torch.randint(n - 4, n, (S,), generator=gen, device=cuda,
                               dtype=torch.int32)
    return table, idx


PROBE_SHAPES = [  # B, S, F, tile_b, n_buf
    (1, 1, 16, 8, 2), (13, 25, 640, 8, 2), (300, 5, 128, 8, 3),
    (64, 1, 32, 4, 1), (17, 25, 64, 16, 2), (1024, 25, 640, 8, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wait", ["sample", "row", "tile"])
@pytest.mark.parametrize("B,S,F,tile_b,n_buf", PROBE_SHAPES)
def test_probe_gather_matches_plain(cuda, dtype, wait, B, S, F, tile_b,
                                    n_buf):
    """K7a's wait variants: B not a multiple of tile_b, S = 1, one ring
    slot, the dummy row to zeros."""
    table, idx = _probe_operands(cuda, B, S, F, 50, dtype, B + S + F)
    before = probe_gather.launches[wait]
    out = probe_gather(table, idx, wait, tile_b, n_buf)
    torch.cuda.synchronize()
    assert probe_gather.launches[wait] == before + 1
    assert out.shape == (B, F) and (out[0] == 0).all()
    torch.testing.assert_close(out, gather_mean_reference(table, idx),
                               **PROBE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [0, 3, 20, 51])
@pytest.mark.parametrize("B,S,F,tile_b,n_buf", PROBE_SHAPES[:4])
def test_probe_gather_hot_matches_plain(cuda, dtype, K, B, S, F, tile_b,
                                        n_buf):
    """K7a hot: K = 0 (every sample cold), K = N + 1 (every sample hot),
    rows all hot and all cold."""
    table, idx = _probe_operands(cuda, B, S, F, 50, dtype, K + B)
    before = probe_gather_hot.launches
    out = probe_gather_hot(table, idx, K, tile_b, n_buf)
    torch.cuda.synchronize()
    assert probe_gather_hot.launches == before + 1
    assert (out[0] == 0).all()
    torch.testing.assert_close(out, gather_mean_reference(table, idx),
                               **PROBE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [0, 3, 20, 51])
@pytest.mark.parametrize("B,S,F,tile_b,n_buf", PROBE_SHAPES[:4])
def test_probe_coldsw_matches_plain(cuda, dtype, K, B, S, F, tile_b, n_buf):
    """K7a compacted on the top_k compaction: live slots only, no cold
    sample at K = N + 1, every sample at K = 0."""
    table, idx = _probe_operands(cuda, B, S, F, 50, dtype, K + S)
    idx_dma, nb, _ = cold_first_topk(idx, K, 50)
    before = probe_coldsw.launches
    out = probe_coldsw(table, idx_dma, nb, S, tile_b, n_buf)
    torch.cuda.synchronize()
    assert probe_coldsw.launches == before + 1
    torch.testing.assert_close(out, coldsw_reference(table, idx_dma, nb, S),
                               **PROBE_TOL)


@pytest.mark.parametrize("K", [0, 16, 100, 301])
@pytest.mark.parametrize("B,S,F", [(128, 1, 8), (256, 25, 640),
                                   (128, 5, 100)])
def test_probe_hotcount_matches_plain(cuda, K, B, S, F):
    """K7b against the plain counts @ the same bf16 block, F not a
    multiple of the column tile, K past the ids; F = 100 (200-byte rows)
    takes the stage route without TMA."""
    table, idx = _probe_operands(cuda, B, S, F, 300, seed=K + S)
    hot = table[:K].to(torch.bfloat16)
    before = probe_hotcount.launches
    out = probe_hotcount(idx, hot)
    torch.cuda.synchronize()
    assert probe_hotcount.launches == before + 1
    torch.testing.assert_close(out, hotcount_reference(idx, hot),
                               **PROBE_TOL)


@pytest.mark.parametrize("K", [0, 16, 100, 301])
@pytest.mark.parametrize("B,S,F,tile_b", [(1, 1, 16, 32), (13, 5, 128, 64),
                                          (40, 25, 640, 32),
                                          (1024, 25, 640, 128)])
def test_probe_hotmx_matches_plain(cuda, K, B, S, F, tile_b):
    """K7c: 2xTF32 counts @ hot rows + the cold rows, at K = 0 (all cold)
    and K = N + 1 (all hot), B not a multiple of tile_b."""
    table, idx = _probe_operands(cuda, B, S, F, 300, seed=K + B)
    before = probe_hotmx.launches
    out = probe_hotmx(table, idx, K, tile_b)
    torch.cuda.synchronize()
    assert probe_hotmx.launches == before + 1
    assert (out[0] == 0).all()
    torch.testing.assert_close(out, hotmx_reference(table, idx, K),
                               **PROBE_TOL)


@pytest.mark.parametrize("S", [1, 25, 40])
@pytest.mark.parametrize("kind,K", [
    ("sample", 0), ("row", 0), ("tile", 0),
    ("hot", 0), ("hot", 1024), ("hot", 3001),
    ("coldsw", 0), ("coldsw", 1024), ("coldsw", 3001),
])
def test_probe_ring_at_its_defaults(cuda, kind, K, S):
    """Every K7a instance with the wrapper's ring (three stages of whole
    rows, ``ring_rows`` rows a stage) against its plain version: F = 640
    f32 and bf16 (one and two rows a stage), B = 37 (a ragged last run
    of items), K = 0 (all cold), 1024 and N + 1 (all hot)."""
    for dtype in (torch.float32, torch.bfloat16):
        table, idx = _probe_operands(cuda, 37, S, 640, 3000, dtype, K + S)
        if kind == "coldsw":
            idx_dma, nb, _ = cold_first_topk(idx, K, 3000)
            out = probe_coldsw(table, idx_dma, nb, S)
            want = coldsw_reference(table, idx_dma, nb, S)
        else:
            out = (probe_gather_hot(table, idx, K) if kind == "hot"
                   else probe_gather(table, idx, kind))
            want = gather_mean_reference(table, idx)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, **PROBE_TOL)


@pytest.mark.parametrize("wait", ["sample", "row", "tile"])
@pytest.mark.parametrize("F,tile_b,n_buf", [
    (640, None, 1),     # one stage: each refill waits for the consumers
    (640, None, 7),     # the deepest ring of half rows that fits
    (640, 1, 2),        # whole rows, two stages
    (16, None, 3),      # narrow rows: 40 rows a stage, 1,000 slots
    (64, 16, 2),        # more slots than producer threads
])
def test_probe_ring_edges(cuda, wait, F, tile_b, n_buf):
    """K7a at the edges of its ring: one stage, the deepest, a stage of
    many rows (more slots than producer threads, the ids past the first
    loaded as they are filled), B = 301 not a multiple of the rows a
    stage, hot and compacted at the same edges."""
    table, idx = _probe_operands(cuda, 301, 25, F, 3000, seed=F + n_buf)
    ring = dict(tile_b=tile_b, n_buf=n_buf)
    want = gather_mean_reference(table, idx)
    torch.testing.assert_close(probe_gather(table, idx, wait, **ring), want,
                               **PROBE_TOL)
    if wait == "sample":
        torch.testing.assert_close(probe_gather_hot(table, idx, 1024, **ring),
                                   want, **PROBE_TOL)
    if wait == "row":
        idx_dma, nb, _ = cold_first_topk(idx, 1024, 3000)
        torch.testing.assert_close(
            probe_coldsw(table, idx_dma, nb, 25, **ring),
            coldsw_reference(table, idx_dma, nb, 25), **PROBE_TOL)


def _probe_shape(cuda, dist):
    """The probe's table [100001, 640] f32 (zero dummy row) and one [1024,
    25] id set of its zipf(1.05) or uniform ids."""
    from graphsage_tpu_torch.benchmarks import gather_probe as gp

    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(gp.N + 1, gp.F, generator=gen, device=cuda)
    table[gp.N] = 0
    ids = gp.make_ids(dist, np.random.default_rng(1), 1)[0]
    return table, torch.from_numpy(ids).to(cuda)


@pytest.mark.parametrize("S", [33, 100, 256])
def test_probe_counts_kernels_on_long_rows(cuda, S):
    """Rows of more than 32 samples take the sort by rank instead of the
    warp's bitonic network: K7b up to its S of 256, K7c at 64 rows a
    tile (S = 256 there needs 32)."""
    table, idx = _probe_operands(cuda, 128, S, 640, 300, seed=S)
    idx[3] = 7                                      # one id S times
    hot = table[:100].to(torch.bfloat16)
    torch.testing.assert_close(probe_hotcount(idx, hot),
                               hotcount_reference(idx, hot), **PROBE_TOL)
    tile_b = 64 if S <= 100 else 32
    torch.testing.assert_close(probe_hotmx(table, idx, 100, tile_b),
                               hotmx_reference(table, idx, 100), **PROBE_TOL)


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("K", [1024, 4096])
def test_probe_counts_kernels_at_the_probe_shape(cuda, dist, K):
    """K7b and K7c (every tile) at the probe's shape, K 1024 and 4096:
    512 k-steps of 8 at 4096, the accumulators' flush every 16."""
    table, idx = _probe_shape(cuda, dist)
    hot = table[:K].to(torch.bfloat16)
    torch.testing.assert_close(probe_hotcount(idx, hot),
                               hotcount_reference(idx, hot), **PROBE_TOL)
    want = hotmx_reference(table, idx, K)
    for tile_b in probe_ops.MX_TILES:
        torch.testing.assert_close(probe_hotmx(table, idx, K, tile_b), want,
                                   **PROBE_TOL)


@pytest.mark.parametrize("kind", ["sample", "row", "tile", "hot", "coldsw",
                                  "hotcount", "hotmx"])
def test_probe_kernels_repeat_bit_for_bit(cuda, kind):
    table, idx = _probe_operands(cuda, 256, 25, 640, 3000, seed=7)
    idx_dma, nb, _ = cold_first_topk(idx, 512, 3000)
    hot = table[:512].to(torch.bfloat16)
    run = {
        "hot": lambda: probe_gather_hot(table, idx, 512),
        "coldsw": lambda: probe_coldsw(table, idx_dma, nb, 25),
        "hotcount": lambda: probe_hotcount(idx, hot),
        "hotmx": lambda: probe_hotmx(table, idx, 512),
    }.get(kind, lambda: probe_gather(table, idx, kind))
    assert torch.equal(run(), run())


TRAP = """
import torch
from graphsage_tpu_torch.ops import gather_probe as gp
dev = torch.device("cuda")
table = torch.zeros(11, 16, device=dev)
idx = torch.full((128, 3), 2, dtype=torch.int32, device=dev)
idx[5, 1] = 11            # one past the table
kind = {kind!r}
if kind == "hotmx":
    gp.probe_hotmx(table, idx, 4)
elif kind == "coldsw":
    gp.probe_coldsw(table, torch.full((128, 4), 11, dtype=torch.int32,
                                      device=dev),
                    torch.ones(128, dtype=torch.int32, device=dev), 3)
elif kind == "hot":
    gp.probe_gather_hot(table, idx, 4)
else:
    gp.probe_gather(table, idx, kind)
torch.cuda.synchronize()
print("NO TRAP")
"""


@pytest.mark.parametrize("kind", ["sample", "row", "tile", "hot", "coldsw",
                                  "hotmx"])
def test_probe_out_of_range_id_traps(cuda, kind):
    """An id past the table stops the kernel (in a process of its own:
    a trap ends the CUDA context)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", TRAP.format(kind=kind)],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode != 0 and "NO TRAP" not in proc.stdout


@pytest.mark.parametrize("kind", ["row", "hotmx", "hotcount"])
def test_probe_launch_refuses_another_smem_size(cuda, monkeypatch, kind):
    """The wrapper sizes shared memory and the kernel's source lays it
    out: a size that is not the layout's is refused, not launched."""
    table, idx = _probe_operands(cuda, 128, 5, 64, 50)
    name = {"hotmx": "hotmx_bytes", "hotcount": "hotcount_bytes"}.get(
        kind, "ring_bytes")
    sized = getattr(probe_ops, name)
    monkeypatch.setattr(probe_ops, name, lambda *a: sized(*a) + 16)
    before = (dict(probe_gather.launches), probe_hotmx.launches,
              probe_hotcount.launches)
    with pytest.raises(RuntimeError, match="not the kernel's layout"):
        if kind == "hotmx":
            probe_hotmx(table, idx, 4)
        elif kind == "hotcount":
            probe_hotcount(idx, table[:8].to(torch.bfloat16))
        else:
            probe_gather(table, idx, "row")
    assert (dict(probe_gather.launches), probe_hotmx.launches,
            probe_hotcount.launches) == before


# ------------------------------------------- the unsupervised slice

UNSUP_HOP = (2 * 512 + 20) * 10     # (2B + n_neg) * S2 = 10,440 rows


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k3_at_the_unsupervised_hop(cuda, dedup, dtype):
    """K1 and K3 at the three towers' innermost hop, idx [10440, 25] as
    the sampler draws it over a zipf adjacency of 100k nodes, against
    their plain versions."""
    n = 100_000
    idx = torch.from_numpy(np.ascontiguousarray(
        _hop_like_idx(np.random.default_rng(12), n, batch=UNSUP_HOP // 10),
        dtype=np.int32)).to(cuda)
    assert idx.shape == (UNSUP_HOP, 25)
    gen = torch.Generator(device=cuda).manual_seed(13)
    table = torch.randn(n + 1, 602, generator=gen, device=cuda).to(dtype)
    table[n] = 0
    ref = (gather_mean_dedup_reference if dedup
           else gather_mean_reference)(table.cpu(), idx.cpu())
    torch.testing.assert_close(fused_gather_mean(table, idx,
                                                 dedup=dedup).cpu(),
                               ref, **TOLERANCES[dtype])


@pytest.mark.parametrize("aggregator", ["mean", "meanpool"])
def test_unsupervised_step_on_card_matches_cpu(cuda, aggregator):
    """One step of the unsupervised chunk runner on the card (K1 for
    mean, K6 for meanpool) and on the CPU (their plain versions), from
    the same weights with the same pairs and negatives, first_k
    sampling and dropout 0: the loss and MRR within 1e-5, the params
    after Adam's step within 1e-4."""
    from graphsage_tpu_torch.data.adjacency import build_both_adjs
    from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        UnsupervisedConfig,
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.ops.gather import fused_gather_mean as gm
    from graphsage_tpu_torch.ops.pool import fused_gather_mlp_pool as gp
    from graphsage_tpu_torch.parallel.dp import (
        make_unsupervised_chunk_runner,
    )

    g = make_synthetic_graph(num_nodes=300, num_classes=3, feat_dim=32,
                             seed=4)
    adj, _, _ = build_both_adjs(g, 12, seed=1)
    config = UnsupervisedConfig(
        sage=SAGEConfig(layers=(LayerInfo(5, 16), LayerInfo(4, 16)),
                        feature_dim=32, aggregator=aggregator,
                        num_nodes=g.num_nodes, sampler_mode="first_k",
                        fused_gather=True))
    rng = np.random.default_rng(5)
    pairs = g.edges[rng.permutation(len(g.edges))[:32]].astype(np.int32)
    # no negative is a positive: such a tie ranks by rounding
    negs = rng.choice(np.setdiff1d(np.arange(g.num_nodes), pairs[:, 1]),
                      (1, 6)).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                          config, dev)
        optimizer = make_optimizer(0.01)
        opt_state = optimizer.init(params)
        run = make_unsupervised_chunk_runner(config, optimizer, 32)
        before = (gm.launches, gp.train_launches)
        params, _, shadow, loss, mrr = run(
            params, opt_state, torch.tensor(-1.0, device=dev), None,
            torch.from_numpy(g.padded_features()).to(dev),
            torch.from_numpy(adj).to(dev), torch.from_numpy(pairs).to(dev),
            torch.from_numpy(negs).to(dev), 0, 1)
        after = (gm.launches, gp.train_launches)
        out[dev.type] = (params, float(loss), float(mrr), float(shadow),
                         after[0] - before[0], after[1] - before[1])
    card, cpu = out["cuda"], out["cpu"]
    assert card[4:] == ((1, 0) if aggregator == "mean" else (0, 1))
    assert cpu[4:] == (0, 0)
    assert abs(card[1] - cpu[1]) <= 1e-5 and abs(card[2] - cpu[2]) <= 1e-5
    assert card[3] == card[2]       # the EMA's sentinel takes the first MRR
    for k in cpu[0]:
        torch.testing.assert_close(card[0][k].detach().cpu(),
                                   cpu[0][k].detach(), rtol=0, atol=1e-4)


def test_positive_equal_to_negatives_ranks_last(cuda):
    """Every negative is row 0's positive node: the one product that
    scores both ties them exactly on the card, so row 0 ranks last."""
    from graphsage_tpu_torch.data.adjacency import build_both_adjs
    from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
    from graphsage_tpu_torch.models.unsupervised import (
        UnsupervisedConfig,
        init_unsupervised_params,
        unsupervised_loss,
    )

    g = make_synthetic_graph(num_nodes=300, num_classes=3, feat_dim=32,
                             seed=4)
    adj, _, _ = build_both_adjs(g, 12, seed=1)
    config = UnsupervisedConfig(
        sage=SAGEConfig(layers=(LayerInfo(5, 16), LayerInfo(4, 16)),
                        feature_dim=32, num_nodes=g.num_nodes,
                        sampler_mode="first_k", fused_gather=True))
    pairs = torch.from_numpy(g.edges[:64].astype(np.int32)).to(cuda)
    params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                      config, cuda)
    _, aux = unsupervised_loss(
        params, torch.from_numpy(g.padded_features()).to(cuda),
        torch.from_numpy(adj).to(cuda), pairs[:, 0], pairs[:, 1],
        torch.ones(64, device=cuda), pairs[0, 1].repeat(8), config)
    assert int(aux["ranks"][0]) == 9


def test_node2vec_runner_on_card_matches_cpu(cuda):
    """Three node2vec steps with the freeze mask on the card and on the
    CPU, from the same tables, pairs and host-noise negatives: the
    negatives equal, the params within 1e-5, the frozen context rows
    bit-identical to the start."""
    from graphsage_tpu_torch.models import node2vec as n2v
    from graphsage_tpu_torch.nn.negative import (
        sample_negatives_unique,
        unigram_logits,
    )
    from graphsage_tpu_torch.parallel.dp import make_node2vec_chunk_runner

    n, d, b = 400, 32, 64
    config = n2v.Node2VecConfig(n + 1, d, 8, 2.0)
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, n, (3 * b, 2)).astype(np.int32)
    deg = np.append(rng.integers(0, 6, n), 0).astype(np.float32)
    mask = np.append(rng.random(n) < 0.3, False).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = n2v.init_node2vec_params(torch.Generator().manual_seed(1),
                                          config, dev)
        start = params["context"].detach().clone()
        opt = n2v.make_optimizer(2.0)
        opt_state = opt.init(params)
        negs = sample_negatives_unique(np.random.default_rng(9),
                                       unigram_logits(deg).to(dev), 8, 3)
        run = make_node2vec_chunk_runner(config, opt, b, n,
                                         with_update_mask=True)
        run(params, opt_state, torch.tensor(-1.0, device=dev),
            torch.from_numpy(pairs).to(dev), negs, 0, 3,
            torch.from_numpy(mask).to(dev))
        frozen = torch.from_numpy(mask == 0).to(dev)
        assert torch.equal(params["context"].detach()[frozen], start[frozen])
        out[dev.type] = ({k: v.detach().cpu() for k, v in params.items()},
                         negs.cpu())
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    for k in out["cpu"][0]:
        torch.testing.assert_close(out["cuda"][0][k], out["cpu"][0][k],
                                   rtol=1e-5, atol=1e-5)


def test_eval_fit_on_card_matches_cpu(cuda):
    """The eval's SGD logistic regression on the card and on the CPU
    (float64, one shuffle per epoch), on tests/test_evaluation.py's
    three-class problem, whose fit moves by 1e-13 of its norm when X
    moves by 1e-13 (on overlapping classes SGD's first epochs, at eta
    ~10, grow such differences to a quarter of it): the same epochs and
    predictions, coefficients within 1e-9 of their largest."""
    from graphsage_tpu_torch.evaluation import LogisticSGD

    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 200)
    x = np.eye(3, 8)[y] * 4 + rng.normal(0, 0.5, (200, 8))
    card = LogisticSGD(seed=4, device=cuda).fit(x, y)
    cpu = LogisticSGD(seed=4, device="cpu").fit(x, y)
    assert list(card.n_iter_) == list(cpu.n_iter_)
    np.testing.assert_array_equal(card.predict(x), cpu.predict(x))
    scale = cpu.coef_.abs().max()
    assert (card.coef_.cpu() - cpu.coef_).abs().max() <= 1e-9 * scale
