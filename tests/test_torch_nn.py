"""The port's nn layer (init, dense, sampler, the mean, gcn and pooling
aggregators) against graphsage_tpu/nn on the same inputs and weights
(the seq aggregator and its LSTM: tests/test_torch_lstm.py)."""

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


def test_dense_bf16_input_matches_jax():
    """A bf16 input against an f32 weight is promoted, as jnp.dot with
    preferred_element_type=f32 promotes it; tolerance as the f32 test
    (bf16 -> f32 is exact, the f32 sums differ in order only)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    jp = jax_init_dense(jax.random.key(4), 12, 5)
    out = apply_dense(port_params(jp), t(x).to(torch.bfloat16),
                      act=torch.relu)
    ref = jax_apply_dense(jp, jnp.asarray(x, dtype=jnp.bfloat16),
                          act=jax.nn.relu)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,concat,bias,model_size,pre_pooled", [
    (name, concat, bias, size, pre)
    for name, concat, bias, size in (
        ("maxpool", True, False, "small"), ("maxpool", False, True, "small"),
        ("meanpool", True, False, "small"), ("meanpool", False, True, "big"),
        ("twomaxpool", True, False, "small"),
        ("twomaxpool", False, True, "big"))
    # twomaxpool takes no pre-pooled input in either package
    for pre in ((False,) if name == "twomaxpool" else (False, True))
])
def test_pool_aggregator_matches_jax(name, concat, bias, model_size,
                                     pre_pooled):
    """3-D neighbor rows through the per-neighbor MLP and the reduce, or
    (maxpool, meanpool) the pre-pooled [n, H] MLP output; the duplicated
    neighbor rows give max ties. rtol 1e-5, atol 1e-6 as above."""
    n, S, d, out_dim = 7, 4, 10, 6
    rng = np.random.default_rng([len(name), concat, bias, pre_pooled])
    self_vecs = rng.standard_normal((n, d)).astype(np.float32)
    jp = jax_aggs.init_aggregator(name, jax.random.key(2), d, out_dim,
                                  model_size=model_size, bias=bias)
    hidden = jp["mlp"][-1]["w"].shape[1]
    if pre_pooled:
        neigh = rng.standard_normal((n, hidden)).astype(np.float32)
        extra = {"pre_pooled": True}
    else:
        neigh = rng.standard_normal((n, S, d)).astype(np.float32)
        neigh[:, 1] = neigh[:, 0]
        extra = {}
    if bias:
        jp["b"] = jnp.asarray(rng.standard_normal(out_dim).astype(np.float32))
    ref = jax_aggs.apply_aggregator(
        name, jp, jnp.asarray(self_vecs), jnp.asarray(neigh),
        act=jax.nn.relu, concat=concat, **extra)
    params = port_params(jp)
    assert f"mlp.{len(jp['mlp']) - 1}.w" in params
    out = aggregators.apply_aggregator(
        name, params, t(self_vecs), t(neigh), act=torch.relu, concat=concat,
        **extra)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    decayed = aggregators.decay_weights(name, params)
    assert len(decayed) == len(jax_aggs.decay_weights(name, jp))
    assert not any(w is params["mlp.0.w"] for w in decayed)
    shapes = {k: tuple(v.shape) for k, v in aggregators.init_aggregator(
        name, torch.Generator().manual_seed(0), d, out_dim,
        model_size=model_size, bias=bias).items()}
    assert shapes == {k: tuple(v.shape) for k, v in params.items()}


def test_pool_dropout_only_inside_the_mlp():
    """Pooling aggregators drop the MLP's input, never the self input:
    with pre-pooled input (no MLP) dropout changes nothing; with 3-D
    input it does."""
    n, S, d = 32, 3, 8
    p = aggregators.init_aggregator("meanpool",
                                    torch.Generator().manual_seed(0), d, 4)
    self_vecs = torch.ones(n, d)
    kw = dict(act=lambda x: x, concat=True, dropout_rate=0.5)
    pooled = torch.rand(n, aggregators.POOL_HIDDEN["small"])
    a = aggregators.apply_meanpool(p, self_vecs, pooled, pre_pooled=True,
                                   generator=torch.Generator().manual_seed(1),
                                   deterministic=False, **kw)
    b = aggregators.apply_meanpool(p, self_vecs, pooled, pre_pooled=True,
                                   **kw)
    assert torch.equal(a, b)
    neigh = torch.ones(n, S, d)
    c = aggregators.apply_meanpool(p, self_vecs, neigh,
                                   generator=torch.Generator().manual_seed(1),
                                   deterministic=False, **kw)
    e = aggregators.apply_meanpool(p, self_vecs, neigh, **kw)
    assert torch.equal(c[:, :4], e[:, :4])        # the self half
    assert not torch.allclose(c[:, 4:], e[:, 4:])


def test_maxpool_grad_splits_ties_as_jax():
    """torch.amax's gradient splits evenly among tied neighbors, as
    jnp.max's does (torch.max(dim=) would route it to one)."""
    rng = np.random.default_rng(8)
    neigh = rng.standard_normal((3, 4, 5)).astype(np.float32)
    neigh[:, 2] = neigh[:, 0]
    jp = jax_aggs.init_aggregator("maxpool", jax.random.key(5), 5, 3)
    self_vecs = rng.standard_normal((3, 5)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jax_aggs.apply_maxpool(
            jp, jnp.asarray(self_vecs), x, act=lambda v: v, concat=True))

    ref = jax.grad(jloss)(jnp.asarray(neigh))
    x = t(neigh).requires_grad_()
    aggregators.apply_maxpool(port_params(jp), t(self_vecs), x,
                              act=lambda v: v, concat=True).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-5,
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
    ("nope", ValueError, "unknown aggregator"),
])
def test_unported_aggregators_raise(name, err, match):
    with pytest.raises(err, match=match):
        aggregators.init_aggregator(name, torch.Generator(), 4, 4)
