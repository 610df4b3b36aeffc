"""K1/K3 at their edges on the CPU: the plain versions against the JAX
package at S across a warp, rows repeated down the idx and all-equal
rows, and the wrapper's one host-side choice, the load width, which the
card's kernels (``csrc/gather_mean.cu``) take as given."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from graphsage_tpu.ops.gather import dedup_compact as jax_dedup_compact
from graphsage_tpu.ops.gather import fused_gather_mean as jax_fused
from graphsage_tpu_torch.ops.gather import (
    _vector_width,
    dedup_compact,
    fused_gather_mean,
)
from tests._torch_common import t


def _idx(kind, B, S, n, rng):
    if kind == "equal":          # one distinct sample per row
        return np.repeat(rng.integers(0, n, (B, 1)), S, axis=1)
    if kind == "repeated":       # 5 rows, each repeated down the idx
        return rng.integers(0, n, (5, S))[np.arange(B) % 5]
    return rng.integers(0, n, (B, S))


EDGES = list(itertools.product([1, 25, 31, 32, 33],
                               ["random", "repeated", "equal"]))


@pytest.mark.parametrize("S,kind", EDGES)
def test_mean_plain_matches_jax_at_edges(S, kind):
    """K1's plain version against the JAX kernel in interpret mode: S
    across a warp, rows repeated down the idx, all-equal rows."""
    rng = np.random.default_rng(S)
    feats = rng.standard_normal((23, 16)).astype(np.float32)
    idx = _idx(kind, 37, S, 23, rng).astype(np.int32)
    out = fused_gather_mean(t(feats), t(idx))
    pallas = jax_fused(jnp.asarray(feats), jnp.asarray(idx), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("S,kind", EDGES)
def test_dedup_plain_matches_jax_at_edges(S, kind):
    """K3's plain version and its compaction against the JAX package's
    (the dedup kernel in interpret mode, ``dedup_compact`` exactly)."""
    rng = np.random.default_rng(S + 100)
    feats = rng.standard_normal((23, 16)).astype(np.float32)
    idx = _idx(kind, 37, S, 23, rng).astype(np.int32)
    out = fused_gather_mean(t(feats), t(idx), dedup=True)
    pallas = jax_fused(jnp.asarray(feats), jnp.asarray(idx), interpret=True,
                       dedup=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)
    idx_u, n_u, w = dedup_compact(t(idx))
    j_idx_u, j_n_u, j_w = (np.asarray(a)
                           for a in jax_dedup_compact(jnp.asarray(idx)))
    np.testing.assert_array_equal(n_u.numpy(), j_n_u)
    np.testing.assert_array_equal(w.numpy(), j_w)
    for row, n in enumerate(j_n_u):
        np.testing.assert_array_equal(idx_u.numpy()[row, :n],
                                      j_idx_u[row, :n])
    if kind == "equal":
        assert (n_u.numpy() == 1).all()


# ------------------------------------------------------ the load width

# (B, S, F); the table's offset from a 16-byte boundary, in elements
SHAPES = [(5120, 25, 602), (33, 1, 602), (47, 31, 17), (40, 32, 640),
          (40, 33, 1), (7, 25, 1032), (3, 3072, 33), (2, 6144, 33),
          (9, 25, 40000)]
OFFSETS = [0, 1, 2]


@pytest.mark.parametrize("B,S,F", SHAPES)
def test_load_width_keeps_every_row_aligned(B, S, F):
    """For both dtypes and table offsets of 0, 1 and 2 elements, every
    table row starts on a whole load, loads are at most 16 bytes and
    tile the row with no tail, and the f32 output row stays aligned;
    the widest such load is taken."""
    for elem, off in itertools.product((4, 2), OFFSETS):
        vec = _vector_width(F, elem, off * elem, 0)
        assert F % vec == 0 and off % vec == 0 and vec * elem <= 16
        for row in range(64):   # every sample's row starts on a load
            assert (off + row * F) % vec == 0
        wider = 2 * vec
        assert wider * elem > 16 or F % wider or off % wider
    # an output 4 bytes off narrows f32 loads to one element
    assert _vector_width(F, 4, 0, 4) == 1


@pytest.mark.parametrize("elem,off,vec", [
    (4, 0, 2), (4, 2, 2), (4, 1, 1), (2, 0, 2), (2, 1, 1), (2, 2, 2),
])
def test_load_width_follows_the_table(elem, off, vec):
    """F = 602: f32 rows of 2,408 bytes load 8 bytes at a time, bf16
    rows 4; a table that starts off a whole load takes narrower ones;
    F = 640 f32 rows load 16 bytes."""
    assert _vector_width(602, elem, off * elem, 0) == vec
    assert _vector_width(640, 4, 0, 0) == 4
    assert _vector_width(640, 2, 0, 0) == 8
