"""The port's models (graphsage_tpu_torch/models) against
graphsage_tpu/models under the deterministic first_k sampler, with the
JAX package's weights carried across by the bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.ops import gather as jgather
from graphsage_tpu.ops import pool as jpool
from graphsage_tpu.ops.gather import pad_feature_dim
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from tests._torch_common import port_params, t

FANOUTS_2 = ((4, 8), (3, 8))
FANOUTS_3 = ((4, 8), (3, 8), (2, 8))


@pytest.fixture(scope="module")
def toy():
    """(graph, padded features, full adjacency, ids): the batch ends with
    the dummy node N, as a padded last batch does."""
    g = make_synthetic_graph(num_nodes=120, num_classes=3, feat_dim=8,
                             seed=7)
    _, _, adj = build_both_adjs(g, 8, seed=1)
    ids = np.concatenate([np.arange(0, 120, 9), [g.num_nodes]]).astype(
        np.int32)
    return g, g.padded_features(), adj, ids


def _configs(aggregator, layers, identity_dim, fused, num_nodes):
    mult = 2 if aggregator == "gcn" else 1
    kw = dict(feature_dim=8, aggregator=aggregator,
              concat=aggregator != "gcn", identity_dim=identity_dim,
              num_nodes=num_nodes, sampler_mode="first_k",
              fused_gather=fused)
    jcfg = jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, mult * d) for s, d in layers), **kw)
    tcfg = tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, mult * d) for s, d in layers), **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("aggregator,layers,identity_dim", [
    ("mean", FANOUTS_2, 0), ("gcn", FANOUTS_2, 0), ("mean", FANOUTS_2, 4),
    ("gcn", FANOUTS_2, 4), ("mean", FANOUTS_3, 0),
])
def test_sage_embed_matches_jax(toy, aggregator, layers, identity_dim,
                                fused):
    g, feats, adj, ids = toy
    jcfg, tcfg = _configs(aggregator, layers, identity_dim, fused,
                          g.num_nodes)
    jparams = jg.init_sage_params(jax.random.key(0), jcfg)
    ref = jg.sage_embed(jparams, jnp.asarray(feats), jnp.asarray(adj),
                        jnp.asarray(ids), jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), t(feats), t(adj), t(ids),
                        tcfg)
    assert out.shape == ref.shape == (len(ids), jcfg.output_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_bf16_table_single_layer_matches_jax(toy):
    """A bf16 table in a one-layer model: only the innermost hop, which
    both packages' fused paths reduce in f32."""
    g, feats, adj, ids = toy
    jcfg, tcfg = _configs("mean", ((4, 8),), 0, True, g.num_nodes)
    jparams = jg.init_sage_params(jax.random.key(0), jcfg)
    ref = jg.sage_embed(jparams, jnp.asarray(feats, dtype=jnp.bfloat16),
                        jnp.asarray(adj), jnp.asarray(ids),
                        jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), t(feats).to(torch.bfloat16),
                        t(adj), t(ids), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("aggregator,identity_dim,fused", [
    ("mean", 0, True), ("gcn", 0, True), ("mean", 4, True),
    ("mean", 0, False), ("gcn", 0, False),
])
def test_bf16_table_two_layers_matches_jax(toy, aggregator, identity_dim,
                                           fused):
    """The outer hops' bf16 rows stay bf16 through the neighbor mean,
    which rounds to bf16 as jnp.mean does; then one training step (loss,
    gradients, Adam) on both sides. Tolerances as the f32 tests: the
    rounding points are the same, the f32 sums differ in order only."""
    from graphsage_tpu.parallel import dp as jdp
    from graphsage_tpu_torch.parallel import dp as tdp

    g, feats, adj, ids = toy
    jcfg, tcfg = _configs(aggregator, FANOUTS_2, identity_dim, fused,
                          g.num_nodes)
    jparams = jg.init_sage_params(jax.random.key(0), jcfg)
    jfeats = jnp.asarray(feats, dtype=jnp.bfloat16)
    tfeats = t(feats).to(torch.bfloat16)
    ref = jg.sage_embed(jparams, jfeats, jnp.asarray(adj), jnp.asarray(ids),
                        jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), tfeats, t(adj), t(ids), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)

    jsup = js.SupervisedConfig(sage=jcfg, num_classes=3)
    tsup = ts.SupervisedConfig(sage=tcfg, num_classes=3)
    labels = np.eye(3, dtype=np.float32)[g.labels[ids[:-1]].argmax(1)]
    labels = np.concatenate([labels, np.zeros((1, 3), np.float32)])
    mask = (ids != g.num_nodes).astype(np.float32)
    jsp = js.init_supervised_params(jax.random.key(2), jsup)
    jopt = js.make_optimizer(0.01)
    jnew, _, jloss, _ = jdp.make_supervised_train_step(jsup, jopt)(
        jsp, jopt.init(jsp), jax.random.key(0), jfeats, jnp.asarray(adj),
        jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
    params = port_params(jsp)
    opt = ts.make_optimizer(0.01)
    params, _, loss, _ = tdp.make_supervised_train_step(tsup, opt)(
        params, opt.init(params), None, tfeats, t(adj), t(ids), t(labels),
        t(mask))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = port_params(jnew)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=1e-4, err_msg=k)


def test_frontier_order(toy):
    """The first expansion takes fanouts[-1] neighbors, the last
    fanouts[0]: frontier sizes [B], [B*S2], [B*S2*S1]."""
    g, _, adj, ids = toy
    samples = tg.sample_frontier(None, t(adj), t(ids), (4, 3),
                                 mode="first_k")
    assert [s.numel() for s in samples] == [len(ids), len(ids) * 3,
                                            len(ids) * 12]
    ref = jg.sample_frontier(jax.random.key(0), jnp.asarray(adj),
                             jnp.asarray(ids), (4, 3), mode="first_k")
    for a, b in zip(samples, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("aggregator,identity_dim", [
    ("mean", 0), ("gcn", 0), ("mean", 4),
])
def test_fused_training_dropout_trains(toy, aggregator, identity_dim):
    """dropout > 0 keeps the fused path (K2's plain version on the CPU):
    the training forward is finite, deterministic for one (seed, step)
    and stochastic across steps, parameter gradients flow, and eval is
    unaffected by the dropout setting."""
    g, feats, adj, ids = toy
    _, tcfg = _configs(aggregator, FANOUTS_2, identity_dim, True,
                       g.num_nodes)
    tcfg = dataclasses.replace(tcfg, dropout=0.3)
    params = tg.init_sage_params(torch.Generator().manual_seed(0), tcfg)
    args = (t(feats), t(adj), t(ids), tcfg)

    def train_fwd(p, step):
        return tg.sage_embed(p, *args,
                             generator=torch.Generator().manual_seed(1),
                             deterministic=False, drop_key=(99, step))

    out = train_fwd(params, 0)
    assert torch.isfinite(out).all()
    assert torch.equal(out, train_fwd(params, 0))
    assert not torch.equal(out, train_fwd(params, 1))
    with pytest.raises(ValueError, match="drop_key"):
        tg.sage_embed(params, *args, generator=torch.Generator(),
                      deterministic=False)

    for p in params.values():
        p.requires_grad_(True)
    grads = torch.autograd.grad((train_fwd(params, 0) ** 2).sum(),
                                list(params.values()))
    assert all(torch.isfinite(gr).all() for gr in grads)
    assert any(float(gr.abs().max()) > 0 for gr in grads)

    with torch.no_grad():
        out_eval = tg.sage_embed(params, *args)
        out_eval0 = tg.sage_embed(params, t(feats), t(adj), t(ids),
                                  dataclasses.replace(tcfg, dropout=0.0))
    np.testing.assert_allclose(out_eval.numpy(), out_eval0.numpy(),
                               rtol=1e-6)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(tg.l2_normalize(t(x)).numpy(),
                               np.asarray(jg.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sigmoid,weight_decay", [
    (False, 0.0), (True, 0.0), (False, 0.01), (True, 0.01),
])
def test_supervised_loss_and_predict_match_jax(toy, sigmoid, weight_decay):
    g, feats, adj, ids = toy
    jcfg, tcfg = _configs("mean", FANOUTS_2, 0, True, g.num_nodes)
    C = 3
    jsup = js.SupervisedConfig(sage=jcfg, num_classes=C,
                               sigmoid_loss=sigmoid,
                               weight_decay=weight_decay)
    tsup = ts.SupervisedConfig(sage=tcfg, num_classes=C,
                               sigmoid_loss=sigmoid,
                               weight_decay=weight_decay)
    rng = np.random.default_rng(4)
    labels = (rng.random((len(ids), C)) < 0.4).astype(np.float32)
    if not sigmoid:
        labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, len(ids))]
    mask = (ids != g.num_nodes).astype(np.float32)
    jparams = js.init_supervised_params(jax.random.key(2), jsup)
    jloss, jlogits = js.supervised_loss(
        jparams, jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(ids),
        jnp.asarray(labels), jnp.asarray(mask), jax.random.key(3), jsup,
        deterministic=True)
    loss, logits = ts.supervised_loss(
        port_params(jparams), t(feats), t(adj), t(ids), t(labels), t(mask),
        tsup, deterministic=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ts.supervised_predict(logits, tsup).numpy(),
        np.asarray(js.supervised_predict(jlogits, jsup)),
        rtol=1e-5, atol=1e-5)


def test_init_shapes_match_jax():
    jcfg, tcfg = _configs("mean", FANOUTS_2, 4, True, 120)
    jsup = js.SupervisedConfig(sage=jcfg, num_classes=5)
    tsup = ts.SupervisedConfig(sage=tcfg, num_classes=5)
    want = {k: tuple(v.shape) for k, v in port_params(
        js.init_supervised_params(jax.random.key(0), jsup)).items()}
    got = {k: tuple(v.shape) for k, v in ts.init_supervised_params(
        torch.Generator().manual_seed(0), tsup).items()}
    assert got == want


# ------------------------------------------------------------- pooling

POOL_F = 20   # a logical width of its own: the JAX pool kernel's jit cache
#               does not key on the interpret hook (tests/test_pool.py:257)


def _pool_case(aggregator, fused, layers=FANOUTS_2, num_nodes=60):
    rng = np.random.default_rng(9)
    feats = np.vstack([
        rng.standard_normal((num_nodes, POOL_F)).astype(np.float32),
        np.zeros((1, POOL_F), np.float32),
    ])
    adj = rng.integers(0, num_nodes, (num_nodes + 1, 6), dtype=np.int32)
    ids = np.concatenate([np.arange(0, num_nodes, 7), [num_nodes]]).astype(
        np.int32)
    kw = dict(feature_dim=POOL_F, aggregator=aggregator, concat=True,
              num_nodes=num_nodes, sampler_mode="first_k", fused_gather=fused)
    jcfg = jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, d) for s, d in layers), **kw)
    tcfg = tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, d) for s, d in layers), **kw)
    return feats, adj, ids, jcfg, tcfg


@pytest.mark.parametrize("aggregator,fused", [
    ("meanpool", True), ("meanpool", False), ("maxpool", False),
    ("maxpool", True),
])
def test_pool_sage_embed_matches_jax(monkeypatch, aggregator, fused):
    """sage_embed and its parameter gradients for the pooling models.
    Fused meanpool: the port's gather_mlp_pool_train (its plain version
    here) against the JAX package's Pallas kernel in interpret mode, the
    custom VJP's residual backward on both sides. maxpool is never
    routed through the fused kernel, fused_gather or not. Outputs rtol
    1e-5, atol 1e-5; gradients rtol 1e-4, atol 1e-6 (tests/test_pool.py)."""
    feats, adj, ids, jcfg, tcfg = _pool_case(aggregator, fused)
    if fused:
        monkeypatch.setattr(jpool, "_FORCE_INTERPRET", True)
    jfeats = jnp.asarray(pad_feature_dim(feats))
    jparams = jg.init_sage_params(jax.random.key(3), jcfg)

    def jloss(p):
        return jnp.sum(jg.sage_embed(p, jfeats, jnp.asarray(adj),
                                     jnp.asarray(ids), jax.random.key(4),
                                     jcfg) ** 2)

    ref = jg.sage_embed(jparams, jfeats, jnp.asarray(adj), jnp.asarray(ids),
                        jax.random.key(4), jcfg)
    jgrads = port_params(jax.grad(jloss)(jparams))

    params = port_params(jparams)
    for p in params.values():
        p.requires_grad_(True)
    out = tg.sage_embed(params, t(feats), t(adj), t(ids), tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out ** 2).sum(), list(params.values()))
    for k, gr in zip(params, grads):
        np.testing.assert_allclose(gr.numpy(), jgrads[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("layers", [((4, 8),), FANOUTS_2],
                         ids=["one_layer", "two_layers"])
def test_pool_bf16_table_matches_jax(layers):
    """meanpool (fused) with a bf16 table: the innermost hop's rows are
    upcast to f32 before the MLP in both packages, the outer hops' rows
    stay bf16 until the MLP's product promotes them. 1e-5 as the f32
    tests: bf16 -> f32 is exact, the rounding points are the same."""
    feats, adj, ids, jcfg, tcfg = _pool_case("meanpool", True, layers)
    jparams = jg.init_sage_params(jax.random.key(5), jcfg)
    ref = jg.sage_embed(jparams, jnp.asarray(feats, dtype=jnp.bfloat16),
                        jnp.asarray(adj), jnp.asarray(ids),
                        jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), t(feats).to(torch.bfloat16),
                        t(adj), t(ids), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_meanpool_fused_dropout_trains():
    """dropout > 0 keeps the fused meanpool path (K6's plain version on
    the CPU): deterministic for one (seed, step), a new mask per step,
    gradients reach the innermost hop's MLP."""
    feats, adj, ids, _, tcfg = _pool_case("meanpool", True)
    tcfg = dataclasses.replace(tcfg, dropout=0.3)
    params = tg.init_sage_params(torch.Generator().manual_seed(0), tcfg)
    for p in params.values():
        p.requires_grad_(True)

    def train_fwd(step):
        return tg.sage_embed(params, t(feats), t(adj), t(ids), tcfg,
                             generator=torch.Generator().manual_seed(1),
                             deterministic=False, drop_key=(99, step))

    out = train_fwd(0)
    assert torch.equal(out, train_fwd(0))
    assert not torch.equal(out, train_fwd(1))
    (out ** 2).sum().backward()
    assert float(params["aggs.0.mlp.0.w"].grad.abs().max()) > 0


@pytest.mark.parametrize("aggregator,model_size", [
    ("maxpool", "small"), ("meanpool", "big"), ("twomaxpool", "small"),
])
def test_pool_init_shapes_match_jax(aggregator, model_size):
    kw = dict(feature_dim=8, aggregator=aggregator, concat=True,
              model_size=model_size, num_nodes=50)
    jsup = js.SupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, d) for s, d in FANOUTS_2), **kw),
        num_classes=5)
    tsup = ts.SupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, d) for s, d in FANOUTS_2), **kw),
        num_classes=5)
    want = {k: tuple(v.shape) for k, v in port_params(
        js.init_supervised_params(jax.random.key(0), jsup)).items()}
    got = {k: tuple(v.shape) for k, v in ts.init_supervised_params(
        torch.Generator().manual_seed(0), tsup).items()}
    assert got == want


# ------------------------------------- dedup_gather and rows_gather

def _jax_kernels_interpreted(monkeypatch):
    """The JAX package's gather kernels in interpret mode, as
    tests/test_ops.py runs them (sage_embed imports them at call time)."""
    for name in ("fused_gather_mean", "fused_gather_rows"):
        orig = getattr(jgather, name)
        monkeypatch.setattr(jgather, name,
                            lambda *a, _f=orig, **kw: _f(*a, interpret=True,
                                                         **kw))


def _recording(monkeypatch, name):
    """Wrap the port's ``name`` in models/graphsage.py; returns the list
    of the keyword arguments of its calls."""
    calls = []
    orig = getattr(tg, name)

    def wrapped(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(tg, name, wrapped)
    return calls


@pytest.mark.parametrize("aggregator,identity_dim,fused", [
    ("seq", 0, True), ("seq", 4, False), ("maxpool", 4, True),
    ("twomaxpool", 0, True), ("mean", 0, False),
])
def test_rows_gather_sage_embed_matches_jax(monkeypatch, aggregator,
                                            identity_dim, fused):
    """rows_gather where no fused kernel takes the innermost hop: the
    port gathers its rows through fused_gather_rows (K4's plain version
    here), the JAX package through its row kernel in interpret mode;
    identity columns in front. tests/test_ops.py's rtol 1e-4, atol
    1e-5."""
    feats, adj, ids, jcfg, tcfg = _pool_case(aggregator, fused)
    jcfg = dataclasses.replace(jcfg, rows_gather=True,
                               identity_dim=identity_dim)
    tcfg = dataclasses.replace(tcfg, rows_gather=True,
                               identity_dim=identity_dim)
    _jax_kernels_interpreted(monkeypatch)
    calls = _recording(monkeypatch, "fused_gather_rows")
    jparams = jg.init_sage_params(jax.random.key(6), jcfg)
    ref = jg.sage_embed(jparams, jnp.asarray(feats), jnp.asarray(adj),
                        jnp.asarray(ids), jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), t(feats), t(adj), t(ids),
                        tcfg)
    assert len(calls) == 1
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("aggregator,identity_dim", [
    ("mean", 0), ("gcn", 0), ("mean", 4),
])
def test_dedup_gather_sage_embed_matches_jax(monkeypatch, toy, aggregator,
                                             identity_dim):
    """fused_gather with dedup_gather: the port's fused_gather_mean with
    dedup (K3's plain version) against the JAX dedup kernel in interpret
    mode. rtol 1e-4, atol 1e-5 as above."""
    g, feats, adj, ids = toy
    jcfg, tcfg = _configs(aggregator, FANOUTS_2, identity_dim, True,
                          g.num_nodes)
    jcfg = dataclasses.replace(jcfg, dedup_gather=True)
    tcfg = dataclasses.replace(tcfg, dedup_gather=True)
    _jax_kernels_interpreted(monkeypatch)
    calls = _recording(monkeypatch, "fused_gather_mean")
    jparams = jg.init_sage_params(jax.random.key(0), jcfg)
    ref = jg.sage_embed(jparams, jnp.asarray(feats), jnp.asarray(adj),
                        jnp.asarray(ids), jax.random.key(1), jcfg)
    out = tg.sage_embed(port_params(jparams), t(feats), t(adj), t(ids),
                        tcfg)
    assert [kw["dedup"] for kw in calls] == [True]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("aggregator,identity_dim,route", [
    ("mean", 0, "fused_gather_mean"), ("mean", 4, "fused_gather_mean"),
    ("meanpool", 0, "gather_mlp_pool_train"),
    ("meanpool", 4, "fused_gather_rows"), ("maxpool", 0, "fused_gather_rows"),
])
def test_rows_gather_only_where_no_fused_route(monkeypatch, aggregator,
                                               identity_dim, route):
    """With every flag on, the fused routes keep the hop (mean/gcn: the
    gather-mean, meanpool: the gather-MLP-pool); K4's wrapper takes it
    only where neither does, as in the JAX package."""
    feats, adj, ids, _, tcfg = _pool_case(aggregator, True)
    tcfg = dataclasses.replace(tcfg, rows_gather=True, dedup_gather=True,
                               identity_dim=identity_dim)
    names = ("fused_gather_mean", "gather_mlp_pool_train",
             "fused_gather_rows")
    calls = {name: _recording(monkeypatch, name) for name in names}
    params = tg.init_sage_params(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        out = tg.sage_embed(params, t(feats), t(adj), t(ids), tcfg)
    assert torch.isfinite(out).all()
    assert {name: len(c) for name, c in calls.items()} == {
        name: int(name == route) for name in names}


def test_dedup_ignored_under_dropout_training(toy):
    """Training with dropout takes K2's mask whether or not dedup_gather
    is set: the same forward for the same (seed, step)."""
    g, feats, adj, ids = toy
    _, tcfg = _configs("mean", FANOUTS_2, 0, True, g.num_nodes)
    tcfg = dataclasses.replace(tcfg, dropout=0.3)
    params = tg.init_sage_params(torch.Generator().manual_seed(0), tcfg)

    def train_fwd(cfg):
        return tg.sage_embed(params, t(feats), t(adj), t(ids), cfg,
                             generator=torch.Generator().manual_seed(1),
                             deterministic=False, drop_key=(5, 2))

    assert torch.equal(
        train_fwd(dataclasses.replace(tcfg, dedup_gather=True)),
        train_fwd(tcfg))
