"""The port's nn layer (init, dense, sampler, mean/gcn aggregators)
against graphsage_tpu/nn on the same inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.nn import aggregators as jax_aggs
from graphsage_tpu.nn.dense import apply_dense as jax_apply_dense
from graphsage_tpu.nn.dense import init_dense as jax_init_dense
from graphsage_tpu.nn.sampler import uniform_sample as jax_uniform_sample
from graphsage_tpu_torch.nn import aggregators
from graphsage_tpu_torch.nn.dense import apply_dense
from graphsage_tpu_torch.nn.init import dropout, glorot
from graphsage_tpu_torch.nn.sampler import uniform_sample
from tests._torch_common import port_params, t


def test_first_k_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    adj = rng.integers(0, 50, (51, 12), dtype=np.int32)
    ids = rng.integers(0, 51, (17,), dtype=np.int32)
    out = uniform_sample(None, t(adj), t(ids), 5, mode="first_k")
    ref = jax_uniform_sample(jax.random.key(0), jnp.asarray(adj),
                             jnp.asarray(ids), 5, mode="first_k")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _column_adj(n, d):
    """adj[i, j] = i*d + j, so a sampled value names its row and column."""
    return torch.arange(n * d, dtype=torch.int32).view(n, d)


def test_shared_perm_shares_one_column_set():
    n, d, k = 30, 16, 7
    adj = _column_adj(n, d)
    ids = torch.arange(n, dtype=torch.int32).flip(0)
    gen = torch.Generator().manual_seed(5)
    out = uniform_sample(gen, adj, ids, k, mode="shared_perm")
    rows = out.long() // d
    cols = out.long() % d
    assert out.shape == (n, k)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.repeat(ids.numpy()[:, None], k, 1))
    assert (cols == cols[0]).all()          # every row: the same columns
    assert len(set(cols[0].tolist())) == k  # distinct columns
    again = uniform_sample(torch.Generator().manual_seed(5), adj, ids, k,
                           mode="shared_perm")
    np.testing.assert_array_equal(out.numpy(), again.numpy())


def test_independent_draws_from_each_row():
    n, d, k = 40, 8, 6
    adj = _column_adj(n, d)
    ids = torch.arange(n, dtype=torch.int32)
    out = uniform_sample(torch.Generator().manual_seed(1), adj, ids, k,
                         mode="independent")
    np.testing.assert_array_equal((out.long() // d).numpy(),
                                  np.repeat(np.arange(n)[:, None], k, 1))
    assert len(set((out.long() % d).flatten().tolist())) == d


def test_unknown_sampler_mode_raises():
    with pytest.raises(ValueError, match="sampler mode"):
        uniform_sample(None, _column_adj(4, 4),
                       torch.arange(4, dtype=torch.int32), 2, mode="nope")


def test_glorot_limit_and_seed():
    w = glorot(torch.Generator().manual_seed(0), (60, 40))
    limit = np.sqrt(6.0 / 100)
    assert w.shape == (60, 40) and w.dtype == torch.float32
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    np.testing.assert_array_equal(
        w.numpy(), glorot(torch.Generator().manual_seed(0), (60, 40)).numpy()
    )


def test_dropout_statistics():
    x = torch.ones(200_000)
    y = dropout(torch.Generator().manual_seed(0), x, 0.3, False)
    zero_frac = float((y == 0).float().mean())
    assert abs(zero_frac - 0.3) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.7, rtol=1e-6)
    assert dropout(None, x, 0.3, True) is x
    assert dropout(None, x, 0.0, False) is x


def test_dense_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    jp = jax_init_dense(jax.random.key(3), 12, 5)
    jp["b"] = jnp.asarray(rng.standard_normal(5).astype(np.float32))
    out = apply_dense(port_params(jp), t(x), act=torch.relu)
    ref = jax_apply_dense(jp, jnp.asarray(x), act=jax.nn.relu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name,concat,bias", [
    ("mean", True, False), ("mean", False, False), ("mean", False, True),
    ("gcn", False, False), ("gcn", True, False), ("gcn", False, True),
])
def test_aggregator_matches_jax(name, concat, reduced, bias):
    """(A bias beside concat=True exists in neither package: the bias has
    the nominal width, the concat output twice that.)"""
    n, S, d, out_dim = 11, 6, 10, 7
    rng = np.random.default_rng([len(name), concat, reduced, bias])
    self_vecs = rng.standard_normal((n, d)).astype(np.float32)
    neigh = rng.standard_normal((n, S, d)).astype(np.float32)
    if reduced:
        neigh = neigh.mean(axis=1)
    jp = jax_aggs.init_aggregator(name, jax.random.key(1), d, out_dim,
                                  bias=bias)
    if bias:
        jp["b"] = jnp.asarray(rng.standard_normal(out_dim).astype(np.float32))
    extra = {"n_samples": S} if (reduced and name == "gcn") else {}
    ref = jax_aggs.apply_aggregator(
        name, jp, jnp.asarray(self_vecs), jnp.asarray(neigh),
        act=jax.nn.relu, concat=concat, **extra,
    )
    out = aggregators.apply_aggregator(
        name, port_params(jp), t(self_vecs), t(neigh), act=torch.relu,
        concat=concat, **extra,
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert len(aggregators.decay_weights(name, port_params(jp))) == len(
        jax_aggs.decay_weights(name, jp))


def test_aggregator_neighbor_dropout_skips_reduced_input():
    """Dropout reaches [n, S, d] neighbor rows but not a pre-reduced mean:
    with rate 0.5 the 3-D form changes the output, the 2-D form keeps the
    neighbor half of a concat intact."""
    n, S, d = 64, 5, 8
    p = aggregators.init_aggregator("mean", torch.Generator().manual_seed(0),
                                    d, 4)
    neigh = torch.ones(n, S, d)
    zeros = torch.zeros(n, d)
    kw = dict(act=lambda x: x, concat=True, dropout_rate=0.5,
              deterministic=False)
    reduced = aggregators.apply_mean(
        p, zeros, neigh.mean(1), generator=torch.Generator().manual_seed(1),
        **kw)
    full = aggregators.apply_mean(
        p, zeros, neigh, generator=torch.Generator().manual_seed(1), **kw)
    expected = neigh.mean(1) @ p["neigh_w"]
    np.testing.assert_allclose(reduced[:, 4:].numpy(), expected.numpy(),
                               rtol=1e-6)
    assert not torch.allclose(full[:, 4:], expected)


@pytest.mark.parametrize("name,err,match", [
    ("maxpool", NotImplementedError, "pooling slice"),
    ("seq", NotImplementedError, "seq/LSTM slice"),
    ("nope", ValueError, "unknown aggregator"),
])
def test_unported_aggregators_raise(name, err, match):
    with pytest.raises(err, match=match):
        aggregators.init_aggregator(name, torch.Generator(), 4, 4)
