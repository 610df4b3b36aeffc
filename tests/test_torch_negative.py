"""The port's negative sampling (``nn/negative.py``) against the JAX
package's: the unigram^0.75 CDF bit for bit, the same ids for the same
uniforms, zero-degree nodes never drawn, the draws' distribution, and
node2vec's logits and draws without replacement."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.nn import negative as jn
from graphsage_tpu_torch.nn import negative as tn
from tests._torch_common import t


def _degrees(seed, n=300):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 50, size=n).astype(np.int32)
    deg[rng.random(n) < 0.2] = 0
    deg[0] = 0      # a zero-degree node in front
    deg[-1] = 7
    return deg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("distortion", [0.75, 1.0])
def test_unigram_cdf_bit_equal(seed, distortion):
    deg = _degrees(seed)
    ours = tn.unigram_cdf(deg, distortion)
    theirs = jn.unigram_cdf(deg, distortion)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_same_uniforms_give_jax_ids():
    """Uniforms from a numpy seed, the CDF's own entries (exact ties:
    ``side="left"`` takes the first entry >= u) and 0 map to the ids
    of ``jnp.searchsorted`` then the clip."""
    cdf = tn.unigram_cdf(_degrees(2))
    u = np.concatenate([
        np.random.default_rng(3).random(4000, dtype=np.float32),
        cdf[::7], np.array([0.0, np.nextafter(np.float32(1), 0)],
                           np.float32)]).astype(np.float32)
    want = np.clip(np.asarray(jnp.searchsorted(jnp.asarray(cdf),
                                               jnp.asarray(u), side="left")),
                   0, cdf.shape[0] - 1)
    got = tn.negatives_from_uniforms(t(cdf), t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # any shape: the trainer maps [steps, n_neg] at once
    np.testing.assert_array_equal(
        tn.negatives_from_uniforms(t(cdf), t(u[:4000].reshape(200, 20))
                                   ).numpy().ravel(), want[:4000])


def test_zero_degree_nodes_never_drawn():
    deg = _degrees(4)
    cdf = t(tn.unigram_cdf(deg))
    ids = tn.sample_negatives(torch.Generator().manual_seed(0), cdf, 50000)
    assert ids.dtype == torch.int32 and ids.shape == (50000,)
    assert (deg[ids.numpy()] > 0).all()


def test_negative_sampler_distribution():
    """tests/test_nn.py's check of the JAX sampler, on the port's."""
    degrees = np.array([0, 1, 16, 81, 0], dtype=np.float64)
    cdf = t(tn.unigram_cdf(degrees))
    idx = tn.sample_negatives(torch.Generator().manual_seed(0), cdf,
                              20000).numpy()
    counts = np.bincount(idx, minlength=5)
    assert counts[0] == 0 and counts[4] == 0
    p = degrees ** 0.75
    p = p / p.sum()
    np.testing.assert_allclose(counts[1:4] / counts.sum(), p[1:4], atol=0.02)


def test_unigram_logits_match_jax():
    deg = _degrees(5).astype(np.float32)
    ours = tn.unigram_logits(deg).numpy()
    theirs = np.asarray(jn.unigram_logits(jnp.asarray(deg)))
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
    np.testing.assert_allclose(ours[deg > 0], theirs[deg > 0], atol=1e-6,
                               rtol=1e-6)


def test_unique_negatives_distinct_and_never_zero_degree():
    deg = _degrees(6)
    logits = tn.unigram_logits(deg)
    draws = tn.sample_negatives_unique(np.random.default_rng(1), logits, 40,
                                       20)
    assert draws.dtype == torch.int32 and draws.shape == (20, 40)
    for ids in draws:
        assert len(set(ids.tolist())) == 40
        assert (deg[ids.numpy()] > 0).all()
    # the top k of the logits plus the host's noise, largest first
    noise = tn.gumbel_noise(np.random.default_rng(1), (20, len(deg)))
    np.testing.assert_array_equal(
        draws.numpy(),
        np.argsort(-(logits.numpy() + noise), axis=1, kind="stable")[:, :40])


@pytest.mark.parametrize("cols", [57, 64])
def test_unique_negatives_in_blocks_equal_one_draw(monkeypatch, cols):
    """A chunk of 120 steps drawn in blocks of 7 rows (an odd count of
    values when ``cols`` is odd: the generator's buffered half-word
    crosses a block) picks the ids of one [120, cols] draw."""
    deg = np.append(np.random.default_rng(3).integers(1, 9, cols - 1), 0)
    logits = tn.unigram_logits(deg)
    monkeypatch.setattr(tn, "NOISE_BLOCK_ELEMS", 7 * cols)
    blocks = tn.sample_negatives_unique(np.random.default_rng(4), logits,
                                        10, 120)
    noise = torch.from_numpy(tn.gumbel_noise(np.random.default_rng(4),
                                             (120, cols)))
    whole = torch.topk(logits + noise, 10, dim=-1).indices.to(torch.int32)
    assert blocks.shape == (120, 10)
    assert torch.equal(blocks, whole)
