"""The port's unsupervised model (``models/unsupervised.py``) against the
JAX package's, given the same negatives, under the deterministic first_k
sampler with the JAX weights carried across by the bridge; against the
TF1 trace's ``unsup_mean`` case; and the weight bridge on an
unsupervised pytree (no head).

The JAX ``unsupervised_loss`` draws its negatives inside; the tests
swap its sampler for one that returns the ids the port is handed, so
both packages score the same negatives.

Tolerances: outputs, loss and MRR 1e-5 (atol and rtol); gradients rtol
1e-4, atol 1e-5; ranks identical; the trace at the JAX suite's own
(tests/test_reference_traced.py: outputs and loss 1e-5, MRR 1e-6,
gradients 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import unsupervised as ju
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import unsupervised as tu
from graphsage_tpu_torch.params import params_from_jax, params_to_jax
from tests._torch_common import port_params, t

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
B, N_NEG = 8, 4
LAYERS = ((3, 6), (2, 6))


@pytest.fixture(scope="module")
def toy():
    """(graph, padded features, train adjacency, batch1, batch2, mask,
    negatives): the batches end with two dummy-padded rows, and the
    dummy id N is among the negatives too. No real batch2 node is a
    negative: a positive equal to a negative is a tie that the two
    packages' dot products may round either way."""
    g = make_synthetic_graph(num_nodes=100, num_classes=3, feat_dim=8,
                             seed=4)
    adj, _, _ = build_both_adjs(g, 6, seed=2)
    rng = np.random.default_rng(0)
    n = g.num_nodes
    b1 = np.full(B, n, np.int32)
    b2 = np.full(B, n, np.int32)
    b1[:B - 2] = rng.choice(n, B - 2, replace=False)
    b2[:B - 2] = rng.choice(n, B - 2, replace=False)
    mask = (b1 != n).astype(np.float32)
    others = np.setdiff1d(np.arange(n), b2[:B - 2])
    negs = np.concatenate([rng.choice(others, N_NEG - 1), [n]]).astype(
        np.int32)
    return g, g.padded_features(), adj, b1, b2, mask, negs


def _configs(num_nodes, aggregator="mean", fused=True, dedup=False,
             rows=False, identity_dim=0, weight_decay=0.0, loss_fn="xent"):
    mult = 2 if aggregator == "gcn" else 1
    kw = dict(feature_dim=8, aggregator=aggregator,
              concat=aggregator != "gcn", identity_dim=identity_dim,
              num_nodes=num_nodes, sampler_mode="first_k",
              fused_gather=fused, dedup_gather=dedup, rows_gather=rows)
    unsup = dict(weight_decay=weight_decay, loss_fn=loss_fn)
    jcfg = ju.UnsupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, mult * d) for s, d in LAYERS), **kw),
        neg_sample_size=N_NEG, **unsup)
    tcfg = tu.UnsupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, mult * d) for s, d in LAYERS), **kw),
        **unsup)
    return jcfg, tcfg


@pytest.fixture()
def jax_negatives(monkeypatch):
    """set(ids): the JAX unsupervised model's sampler returns ``ids``."""
    def set_ids(ids):
        monkeypatch.setattr(ju, "sample_negatives",
                            lambda rng, cdf, n: jnp.asarray(ids))
    return set_ids


CASES = [
    # aggregator, fused, dedup, rows, identity_dim, weight_decay, loss_fn
    ("mean", True, False, False, 0, 0.0, "xent"),       # K1's plain path
    ("mean", True, True, False, 0, 0.0, "xent"),        # K3's
    ("mean", False, False, False, 0, 0.01, "xent"),
    ("mean", True, False, False, 4, 0.01, "xent"),
    ("mean", True, False, False, 0, 0.0, "skipgram"),
    ("mean", True, False, False, 0, 0.0, "hinge"),
    ("gcn", True, False, False, 4, 0.01, "xent"),
    ("gcn", True, True, False, 0, 0.0, "xent"),
    ("meanpool", True, False, False, 0, 0.01, "xent"),  # K6's plain path
    ("meanpool", True, False, False, 4, 0.0, "xent"),
    ("maxpool", True, False, True, 0, 0.01, "xent"),    # K4's plain path
    ("maxpool", False, False, False, 4, 0.0, "xent"),
    ("seq", True, False, True, 0, 0.0, "xent"),
    ("seq", True, False, True, 4, 0.01, "xent"),
]


@pytest.mark.parametrize(
    "aggregator,fused,dedup,rows,identity_dim,weight_decay,loss_fn", CASES)
def test_unsupervised_loss_matches_jax(toy, jax_negatives, aggregator, fused,
                                       dedup, rows, identity_dim,
                                       weight_decay, loss_fn):
    g, feats, adj, b1, b2, mask, negs = toy
    jcfg, tcfg = _configs(g.num_nodes, aggregator, fused, dedup, rows,
                          identity_dim, weight_decay, loss_fn)
    jax_negatives(negs)
    jparams = ju.init_unsupervised_params(jax.random.key(3), jcfg)
    jargs = [jnp.asarray(x) for x in (feats, adj, b1, b2, mask)]
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: ju.unsupervised_loss(p, *jargs, None, jax.random.key(0),
                                       jcfg, deterministic=False),
        has_aux=True)(jparams)
    jouts = ju.unsupervised_outputs(
        jparams, jargs[0], jargs[1], jargs[2], jargs[3], None,
        jax.random.key(0), jcfg, deterministic=True)

    params = port_params(jparams)
    for p in params.values():
        p.requires_grad_(True)
    targs = [t(x) for x in (feats, adj, b1, b2, mask)]
    loss, aux = tu.unsupervised_loss(params, *targs, t(negs), tcfg)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    with torch.no_grad():
        outs = tu.unsupervised_outputs(params, targs[0], targs[1], targs[2],
                                       targs[3], t(negs), tcfg)

    for name, o, jo in zip(("out1", "out2", "neg"), outs, jouts):
        assert o.shape == jo.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **VAL,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **VAL)
    np.testing.assert_allclose(float(aux["mrr"]), float(jaux["mrr"]), **VAL)
    # the padded rows score the dummy against itself, among the
    # negatives too: a tie either package may round either way, and
    # their ranks are masked out of the MRR
    real = mask > 0
    np.testing.assert_array_equal(aux["ranks"].numpy()[real],
                                  np.asarray(jaux["ranks"])[real])
    np.testing.assert_allclose(aux["outputs1"].numpy(),
                               np.asarray(jaux["outputs1"]), **VAL)
    want = params_from_jax(jax.device_get(jgrads))
    assert grads.keys() == want.keys()
    for k, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want[k].numpy(), **GRAD,
                                   err_msg=k)


def test_one_embed_call_for_three_towers(toy, monkeypatch):
    """The towers run as one sage_embed over [batch1, batch2, negs]."""
    g, feats, adj, b1, b2, _, negs = toy
    _, tcfg = _configs(g.num_nodes)
    calls = []
    real = tu.sage_embed

    def counting(params, features, adj_, ids, *a, **kw):
        calls.append(ids.shape[0])
        return real(params, features, adj_, ids, *a, **kw)

    monkeypatch.setattr(tu, "sage_embed", counting)
    params = tu.init_unsupervised_params(torch.Generator().manual_seed(0),
                                         tcfg)
    outs = tu.unsupervised_outputs(params, t(feats), t(adj), t(b1), t(b2),
                                   t(negs), tcfg)
    assert calls == [2 * B + N_NEG]
    assert [o.shape[0] for o in outs] == [B, B, N_NEG]
    # unit rows, but the dummy node's zero embedding stays zero
    for o, ids in zip(outs, (b1, b2, negs)):
        np.testing.assert_allclose(o.norm(dim=1).numpy(),
                                   (ids != g.num_nodes).astype(np.float32),
                                   atol=1e-6)


def test_masked_rows_do_not_move_the_loss(toy):
    """Padded rows (mask 0) change neither the loss nor the MRR: the
    loss of the real rows alone, divided by their count."""
    g, feats, adj, b1, b2, mask, negs = toy
    _, tcfg = _configs(g.num_nodes)
    params = tu.init_unsupervised_params(torch.Generator().manual_seed(1),
                                         tcfg)
    k = int(mask.sum())
    full = tu.unsupervised_loss(params, t(feats), t(adj), t(b1), t(b2),
                                t(mask), t(negs), tcfg)
    real = tu.unsupervised_loss(params, t(feats), t(adj), t(b1[:k]),
                                t(b2[:k]), torch.ones(k), t(negs), tcfg)
    np.testing.assert_allclose(float(full[0].detach()),
                               float(real[0].detach()), **VAL)
    np.testing.assert_allclose(float(full[1]["mrr"]),
                               float(real[1]["mrr"]), **VAL)


def test_positive_equal_to_negatives_ranks_below_them(toy):
    """Every negative is row 0's positive node: one product scores both,
    so all tie exactly and row 0 ranks last (tests/test_torch_cuda.py
    holds the card to it too)."""
    g, feats, adj, b1, b2, mask, _ = toy
    _, tcfg = _configs(g.num_nodes, "gcn")
    params = tu.init_unsupervised_params(torch.Generator().manual_seed(2),
                                         tcfg)
    negs = np.full(N_NEG, b2[0], np.int32)
    _, aux = tu.unsupervised_loss(
        params, *(t(x) for x in (feats, adj, b1, b2, mask, negs)), tcfg)
    assert int(aux["ranks"][0]) == N_NEG + 1


# -------------------------------------------------- the TF1 trace

FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                           "reference_traced.npz"))


@pytest.mark.parametrize("fused", [True, False])
def test_unsupervised_model_matches_tf1_trace(fused):
    """The trace's ``unsup_mean``: outputs, loss, MRR, the positive's
    ranks and every gradient."""
    def g(name):
        return FIX[f"unsup_mean/{name}"]

    config = tu.UnsupervisedConfig(
        sage=tg.SAGEConfig(layers=(tg.LayerInfo(3, 6), tg.LayerInfo(2, 6)),
                           feature_dim=8, aggregator="mean", concat=True,
                           num_nodes=12, sampler_mode="first_k",
                           fused_gather=fused))
    params = {}
    for li in range(2):
        for ours, tf in (("neigh_w", "neigh_weights"),
                         ("self_w", "self_weights")):
            params[f"aggs.{li}.{ours}"] = t(
                g(f"var_agg{li}_{tf}")).requires_grad_(True)
    b1 = t(FIX["graph/batch"])
    args = (t(FIX["graph/features"]), t(FIX["graph/adj"]), b1,
            t(g("batch2")))
    with torch.no_grad():
        outs = tu.unsupervised_outputs(params, *args, t(g("neg_ids")),
                                       config)
    for name, o in zip(("outputs1", "outputs2", "neg_outputs"), outs):
        np.testing.assert_allclose(o.numpy(), g(name), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    loss, aux = tu.unsupervised_loss(params, *args, torch.ones(b1.shape[0]),
                                     t(g("neg_ids")), config)
    np.testing.assert_allclose(float(loss.detach()), g("loss"), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["mrr"]), g("mrr"), atol=1e-6,
                               rtol=1e-5)
    # the reference's rank matrix holds the positive last, 0-based
    np.testing.assert_array_equal(aux["ranks"].numpy(), g("ranks")[:, -1] + 1)
    grads = torch.autograd.grad(loss, list(params.values()))
    for k, grad in zip(params, grads):
        layer, leaf = k.split(".")[1:]
        tf = {"neigh_w": "neigh_weights", "self_w": "self_weights"}[leaf]
        np.testing.assert_allclose(grad.numpy(), g(f"grad_agg{layer}_{tf}"),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


# -------------------------------------------------- the weight bridge

@pytest.mark.parametrize("aggregator,identity_dim", [
    ("mean", 4), ("meanpool", 0), ("seq", 3)])
def test_bridge_round_trips_an_unsupervised_pytree(aggregator,
                                                   identity_dim):
    jcfg, tcfg = _configs(30, aggregator, identity_dim=identity_dim)
    tree = jax.device_get(ju.init_unsupervised_params(jax.random.key(2),
                                                      jcfg))
    assert "head" not in tree
    flat = params_from_jax(tree)
    ours = tu.init_unsupervised_params(torch.Generator().manual_seed(0),
                                       tcfg)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    assert ("embeds" in flat) == (identity_dim > 0)
    assert not any(k.startswith("head") for k in flat)
    back = params_to_jax(flat)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
