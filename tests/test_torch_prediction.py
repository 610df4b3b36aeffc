"""The port's edge-prediction losses (``nn/prediction.py``) against the
JAX package's and against the reference TF1 trace.

Tolerances: values 1e-5 (atol and rtol); gradients rtol 1e-4, atol 1e-5;
ranks identical; the trace at the JAX suite's own tolerances
(tests/test_reference_traced.py: affinities 1e-5, loss and grads 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.nn import prediction as jp
from graphsage_tpu_torch.nn import prediction as tp
from tests._torch_common import t

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
B, N_NEG, D = 8, 4, 6


def _inputs(seed, bilinear=False, masked=False):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(B, D)).astype(np.float32)
    x2 = rng.normal(size=(B, D)).astype(np.float32)
    neg = rng.normal(size=(N_NEG, D)).astype(np.float32)
    w = (rng.normal(size=(D, D)).astype(np.float32) * 0.3
         if bilinear else None)
    mask = None
    if masked:
        mask = np.ones(B, dtype=np.float32)
        mask[-3:] = 0.0
    return x1, x2, neg, w, mask


@pytest.mark.parametrize("bilinear", [False, True])
def test_affinities_match_jax(bilinear):
    """``affinity``, ``neg_cost`` and ``edge_pred_scores`` (the scoring
    that training runs) against the JAX ``affinity``/``neg_cost``."""
    x1, x2, neg, w, _ = _inputs(0, bilinear)
    jparams = None if w is None else {"w": jnp.asarray(w)}
    tparams = None if w is None else {"w": t(w)}
    jaff = np.asarray(jp.affinity(jnp.asarray(x1), jnp.asarray(x2),
                                  jparams))
    jneg = np.asarray(jp.neg_cost(jnp.asarray(x1), jnp.asarray(neg),
                                  jparams))
    np.testing.assert_allclose(
        tp.affinity(t(x1), t(x2), tparams).numpy(), jaff, **VAL)
    np.testing.assert_allclose(
        tp.neg_cost(t(x1), t(neg), tparams).numpy(), jneg, **VAL)
    aff, neg_aff = tp.edge_pred_scores(t(x1), t(x2), t(neg), tparams)
    np.testing.assert_allclose(aff.numpy(), jaff, **VAL)
    np.testing.assert_allclose(neg_aff.numpy(), jneg, **VAL)


@pytest.mark.parametrize("bilinear", [False, True])
def test_scores_tie_a_positive_equal_to_a_negative(bilinear):
    """A negative with row 0's positive embedding scores exactly its
    affinity in ``edge_pred_scores``' one product, so row 0 ranks below
    it (rank 2 against it alone, 1 + N_NEG against N_NEG copies)."""
    x1, x2, neg, w, _ = _inputs(4, bilinear)
    tparams = None if w is None else {"w": t(w)}
    neg[1] = x2[0]
    aff, neg_aff = tp.edge_pred_scores(t(x1), t(x2), t(neg), tparams)
    assert float(neg_aff[0, 1]) == float(aff[0])
    ranks, _ = tp.mrr_and_ranks(aff, neg_aff)
    assert int(ranks[0]) == 1 + int((neg_aff[0] >= aff[0]).sum())
    aff, neg_aff = tp.edge_pred_scores(t(x1), t(x2),
                                       t(np.repeat(x2[:1], N_NEG, 0)),
                                       tparams)
    ranks, _ = tp.mrr_and_ranks(aff, neg_aff)
    assert int(ranks[0]) == 1 + N_NEG


def test_sigmoid_xent_and_grad_match_jax():
    """Values and gradients, at a logit of exactly 0 too (a zero
    embedding's affinity), where both take the JAX subgradients."""
    logits = np.array([-80.0, -3.0, -1e-3, 0.0, 2.5, 90.0], np.float32)
    for label in (0.0, 1.0, 0.3):
        labels = np.full_like(logits, label)
        z = t(logits).requires_grad_(True)
        out = tp.sigmoid_xent(t(labels), z)
        (grad,) = torch.autograd.grad(out.sum(), z)
        jout, jgrad = jax.value_and_grad(lambda x: jp.sigmoid_xent(
            jnp.asarray(labels), x).sum())(jnp.asarray(logits))
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jp.sigmoid_xent(
                                       jnp.asarray(labels),
                                       jnp.asarray(logits))), **VAL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD)


@pytest.mark.parametrize("loss_fn,negw", [
    ("xent", 1.0), ("xent", 2.0), ("skipgram", 1.0), ("hinge", 1.0),
])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bilinear", [False, True])
def test_edge_pred_loss_and_grads_match_jax(loss_fn, negw, masked,
                                            bilinear):
    x1, x2, neg, w, mask = _inputs(1, bilinear, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(a, b, c, wt):
        return jp.edge_pred_loss(
            a, b, c, loss_fn=loss_fn,
            params=None if wt is None else {"w": wt}, mask=jmask,
            neg_sample_weights=negw)

    jargs = [jnp.asarray(x) for x in (x1, x2, neg)]
    jw = None if w is None else jnp.asarray(w)
    argnums = (0, 1, 2, 3) if bilinear else (0, 1, 2)
    lv, jgrads = jax.value_and_grad(jloss, argnums=argnums)(*jargs, jw)

    targs = [t(x).requires_grad_(True) for x in (x1, x2, neg)]
    tw = None if w is None else t(w).requires_grad_(True)
    loss = tp.edge_pred_loss(
        *targs, loss_fn=loss_fn, params=None if tw is None else {"w": tw},
        mask=None if mask is None else t(mask), neg_sample_weights=negw)
    grads = torch.autograd.grad(loss, targs + ([tw] if bilinear else []))
    np.testing.assert_allclose(float(loss.detach()), float(lv), **VAL)
    for name, g, jg in zip(("x1", "x2", "neg", "w"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD,
                                   err_msg=name)


def test_masked_rows_add_nothing():
    x1, x2, neg, _, mask = _inputs(2, masked=True)
    for loss_fn in tp.LOSS_FNS:
        full = tp.edge_pred_loss(t(x1), t(x2), t(neg), loss_fn=loss_fn,
                                 mask=t(mask))
        k = int(mask.sum())
        real = tp.edge_pred_loss(t(x1[:k]), t(x2[:k]), t(neg),
                                 loss_fn=loss_fn)
        np.testing.assert_allclose(float(full), float(real), **VAL,
                                   err_msg=loss_fn)


@pytest.mark.parametrize("masked", [False, True])
def test_mrr_and_ranks_match_jax_with_ties(masked):
    """Exact ties between the positive and negatives rank the positive
    below them (>=), as the reference's stable top_k does."""
    rng = np.random.default_rng(3)
    aff = rng.integers(-2, 3, size=B).astype(np.float32)
    neg_aff = rng.integers(-2, 3, size=(B, N_NEG)).astype(np.float32)
    neg_aff[0] = aff[0]           # every negative ties the positive
    neg_aff[1] = aff[1] - 1.0     # none reaches it: rank 1
    mask = np.ones(B, np.float32)
    if masked:
        mask[-2:] = 0.0
    jmask = jnp.asarray(mask) if masked else None
    jranks, jmrr = jp.mrr_and_ranks(jnp.asarray(aff), jnp.asarray(neg_aff),
                                    jmask)
    ranks, mrr = tp.mrr_and_ranks(t(aff), t(neg_aff),
                                  t(mask) if masked else None)
    assert ranks.dtype == torch.int32
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    assert ranks[0] == N_NEG + 1 and ranks[1] == 1
    np.testing.assert_allclose(float(mrr), float(jmrr), **VAL)


def test_init_bilinear_shape():
    w = tp.init_bilinear(torch.Generator().manual_seed(0), 6, 4)["w"]
    assert w.shape == (6, 4) and float(w.abs().max()) <= (6 / 10) ** 0.5


# -------------------------------------------------- the TF1 trace

FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                           "reference_traced.npz"))


@pytest.mark.parametrize("case,loss_fn,negw,bilinear", [
    ("pred_xent", "xent", 1.0, False),
    ("pred_xent_w2", "xent", 2.0, False),
    ("pred_skipgram", "skipgram", 1.0, False),
    ("pred_hinge", "hinge", 1.0, False),
    ("pred_bilinear", "xent", 1.0, True),
])
def test_edge_prediction_matches_tf1_trace(case, loss_fn, negw, bilinear):
    def g(name):
        return FIX[f"{case}/{name}"]

    params = {"w": t(g("var_weights"))} if bilinear else None
    u = [t(g(k)).requires_grad_(True) for k in ("inputs1", "inputs2", "neg")]
    np.testing.assert_allclose(
        tp.affinity(*u[:2], params).detach().numpy(), g("aff"),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tp.neg_cost(u[0], u[2], params).detach().numpy(), g("neg_aff"),
        atol=1e-5, rtol=1e-5)
    aff, neg_aff = tp.edge_pred_scores(*u, params)
    np.testing.assert_allclose(aff.detach().numpy(), g("aff"), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(neg_aff.detach().numpy(), g("neg_aff"),
                               atol=1e-5, rtol=1e-5)
    loss = tp.edge_pred_loss(*u, loss_fn=loss_fn, params=params,
                             neg_sample_weights=negw)
    np.testing.assert_allclose(float(loss.detach()), g("loss"), atol=1e-4,
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, u)
    for name, grad in zip(("inputs1", "inputs2", "neg"), grads):
        np.testing.assert_allclose(grad.numpy(), g(f"grad_{name}"),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
