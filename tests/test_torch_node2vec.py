"""The port's node2vec model (``models/node2vec.py``) and its step and
chunk runner (``parallel/dp.py``) against the JAX package's, given the
same negatives; against the TF1 trace's ``n2v`` case; the freeze mask,
the init and the weight bridge.

The JAX loss draws its negatives inside; the tests inject the ids (the
loss as ``tests/test_reference_traced.py`` writes it, or the JAX
runner's own draws, recomputed from its keys). No negative is a
positive context node: the two packages' products may round such a tie
either way.

Tolerances: loss 1e-5; gradients atol 1e-5, rtol 1e-4; the SGD step
1e-6; MRR 1e-6 and ranks identical; params after several chunk-runner
steps 1e-5; frozen rows bit-identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import node2vec as jn
from graphsage_tpu.nn import prediction as jp
from graphsage_tpu.nn.negative import sample_negatives_unique
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu_torch.models import node2vec as tn
from graphsage_tpu_torch.params import params_from_jax, params_to_jax
from graphsage_tpu_torch.parallel import dp as tdp
from tests._torch_common import t

GRAD = dict(atol=1e-5, rtol=1e-4)
FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                           "reference_traced.npz"))
N, D, B, N_NEG, LR = 50, 8, 8, 4, 0.5


def _jax_loss(params, b1, b2, mask, negs):
    """node2vec_loss with injected negatives."""
    out1, out2, out2_bias, neg, neg_bias = jn.node2vec_outputs(
        params, b1, b2, negs)
    aff = jnp.sum(out1 * out2, axis=1) + out2_bias
    neg_aff = jnp.dot(out1, neg.T) + neg_bias
    true_xent = jp.sigmoid_xent(jnp.ones_like(aff), aff)
    neg_xent = jp.sigmoid_xent(jnp.zeros_like(neg_aff), neg_aff)
    loss = (jnp.sum(true_xent * mask) + jnp.sum(neg_xent * mask[:, None])
            ) / jnp.maximum(jnp.sum(mask), 1.0)
    ranks, mrr = jp.mrr_and_ranks(jp.affinity(out1, out2),
                                  jp.neg_cost(out1, neg), mask)
    return loss, (mrr, ranks)


def _tables(seed=0, n=N + 1, d=D):
    """Random tables and a non-zero bias, from a NumPy seed."""
    rng = np.random.default_rng(seed)
    return {"target": rng.uniform(-1, 1, (n, d)).astype(np.float32),
            "context": rng.normal(0, 0.3, (n, d)).astype(np.float32),
            "bias": rng.normal(0, 0.1, n).astype(np.float32)}


def _batch(seed=1):
    """b1, b2 (contexts < 25, the last two rows dummy-padded), mask and
    negatives drawn from ids 25..N-1 (the dummy rows' context is N, so
    N is no negative either)."""
    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, N, B).astype(np.int32)
    b2 = rng.integers(0, 25, B).astype(np.int32)
    b1[-2:] = N
    b2[-2:] = N
    negs = rng.choice(np.arange(25, N), N_NEG, replace=False).astype(
        np.int32)
    return b1, b2, (b1 != N).astype(np.float32), negs


def _port(tables):
    params = params_from_jax(tables)
    for p in params.values():
        p.requires_grad_(True)
    return params


def test_loss_gradients_and_step_match_jax():
    tables = _tables()
    b1, b2, mask, negs = _batch()
    (jloss, (jmrr, jranks)), jgrads = jax.value_and_grad(
        _jax_loss, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tables),
                                 b1, b2, mask, negs)
    params = _port(tables)
    loss, aux = tn.node2vec_loss(params, t(b1), t(b2), t(mask), t(negs),
                                 tn.Node2VecConfig(N + 1, D, N_NEG, LR))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["mrr"]), float(jmrr), atol=1e-6)
    np.testing.assert_array_equal(aux["ranks"].numpy(), np.asarray(jranks))
    for k in tables:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jgrads[k]), **GRAD, err_msg=k)
    opt = tn.make_optimizer(LR)
    opt.update(opt.init(params), params)
    for k in tables:
        np.testing.assert_allclose(
            params[k].detach().numpy(),
            tables[k] - LR * np.asarray(jgrads[k]), atol=1e-6, err_msg=k)
    # the dummy-padded rows move nothing: their target rows stay
    np.testing.assert_array_equal(params["target"].detach().numpy()[N],
                                  tables["target"][N])


def test_node2vec_matches_tf1_trace():
    case = "n2v"
    tables = {k: FIX[f"{case}/var_{k}"] for k in ("target", "context",
                                                  "bias")}
    b1 = FIX["graph/batch"].astype(np.int32)
    b2 = FIX[f"{case}/batch2"].astype(np.int32)
    negs = FIX[f"{case}/neg_ids"].astype(np.int32)
    params = _port(tables)
    config = tn.Node2VecConfig(tables["target"].shape[0],
                               tables["target"].shape[1], len(negs), 0.5)
    loss, aux = tn.node2vec_loss(params, t(b1), t(b2),
                                 torch.ones(len(b1)), t(negs), config)
    loss.backward()
    np.testing.assert_allclose(loss.item(), FIX[f"{case}/loss"], atol=1e-5)
    np.testing.assert_allclose(float(aux["mrr"]), FIX[f"{case}/mrr"],
                               atol=1e-6)
    np.testing.assert_array_equal(aux["ranks"].numpy(),
                                  FIX[f"{case}/ranks"][:, -1] + 1)
    for k in tables:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   FIX[f"{case}/grad_{k}"], **GRAD,
                                   err_msg=k)
    opt = tn.make_optimizer(0.5)
    opt.update(opt.init(params), params)
    for k in tables:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   FIX[f"{case}/post_{k}"], atol=1e-6,
                                   err_msg=k)


def test_mask_context_gradients_zeroes_frozen_rows_only():
    params = _port(_tables())
    b1, b2, mask, negs = _batch()
    config = tn.Node2VecConfig(N + 1, D, N_NEG, LR)
    tn.node2vec_loss(params, t(b1), t(b2), t(mask), t(negs),
                     config)[0].backward()
    before = params["context"].grad.clone()
    update_mask = torch.zeros(N + 1)
    update_mask[10:] = 1.0
    tn.mask_context_gradients(params, update_mask)
    after = params["context"].grad
    assert (after[:10] == 0).all()
    torch.testing.assert_close(after[10:], before[10:], rtol=0, atol=0)
    assert before[:10].abs().sum() > 0   # something was frozen
    jgrads = jn.mask_context_gradients(
        {"context": jnp.asarray(before.numpy())},
        jnp.asarray(update_mask.numpy()))
    np.testing.assert_array_equal(after.numpy(), np.asarray(
        jgrads["context"]))


def _jax_runner_negatives(key, uni, start, n_steps):
    """The negatives the JAX chunk runner draws at steps start.. ."""
    return np.stack([np.asarray(sample_negatives_unique(
        jax.random.fold_in(key, start + j), uni, N_NEG))
        for j in range(n_steps)])


@pytest.mark.parametrize("with_mask", [False, True])
def test_chunk_runner_matches_jax(with_mask):
    tables = _tables(3)
    rng = np.random.default_rng(2)
    n_steps, start = 5, 1
    pairs = np.stack([rng.integers(0, N, (n_steps + start) * B),
                      rng.integers(0, 25, (n_steps + start) * B)],
                     axis=1).astype(np.int32)
    pairs[-3:] = N        # a dummy-padded tail
    deg = np.zeros(N + 1, np.float32)
    deg[25:N] = rng.integers(1, 9, N - 25)   # negatives: ids >= 25
    uni = jnp.asarray(np.where(deg > 0, 0.75 * np.log(np.maximum(
        deg, 1e-20)), -np.inf).astype(np.float32))
    key = jax.random.key(5)
    update_mask = np.zeros(N + 1, np.float32)
    update_mask[30:] = 1.0
    config_j = jn.Node2VecConfig(N + 1, D, N_NEG, LR)
    opt = jn.make_optimizer(LR)
    jtables = jax.tree_util.tree_map(jnp.asarray, tables)
    runner = jax.jit(jdp.make_node2vec_chunk_runner(
        config_j, opt, B, N, with_update_mask=with_mask))
    args = (jnp.asarray(update_mask),) if with_mask else ()
    jparams, _, jshadow, jloss, jmrr = runner(
        jtables, opt.init(jtables), jnp.asarray(-1.0), key,
        jnp.asarray(pairs), uni, start, n_steps, *args)

    negs = _jax_runner_negatives(key, uni, start, n_steps)
    assert not np.isin(negs, pairs[:, 1][pairs[:, 1] < N]).any()
    params = _port(tables)
    config = tn.Node2VecConfig(N + 1, D, N_NEG, LR)
    optimizer = tn.make_optimizer(LR)
    run = tdp.make_node2vec_chunk_runner(config, optimizer, B, N,
                                         with_update_mask=with_mask)
    targs = (t(update_mask),) if with_mask else ()
    params, _, shadow, loss, mrr = run(
        params, optimizer.init(params), torch.tensor(-1.0), t(pairs),
        t(negs), start, n_steps, *targs)
    for k in tables:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(mrr), float(jmrr), atol=1e-6)
    np.testing.assert_allclose(float(shadow), float(jshadow), atol=1e-6)
    if with_mask:
        np.testing.assert_array_equal(
            params["context"].detach().numpy()[:30], tables["context"][:30])


def test_flag_and_mask_must_agree():
    params = _port(_tables())
    config = tn.Node2VecConfig(N + 1, D, N_NEG, LR)
    opt = tn.make_optimizer(LR)
    b1, b2, mask, negs = _batch()
    update_mask = torch.ones(N + 1)
    step = tdp.make_node2vec_train_step(config, opt, with_update_mask=True)
    with pytest.raises(ValueError, match="no update_mask"):
        step(params, None, t(b1), t(b2), t(mask), t(negs))
    with pytest.raises(ValueError, match="with_update_mask=False"):
        tdp.make_node2vec_train_step(config, opt)(
            params, None, t(b1), t(b2), t(mask), t(negs), update_mask)
    pairs = torch.zeros(B, 2, dtype=torch.int32)
    runner = tdp.make_node2vec_chunk_runner(config, opt, B, N,
                                            with_update_mask=True)
    with pytest.raises(ValueError, match="no update_mask"):
        runner(params, None, torch.tensor(-1.0), pairs, t(negs)[None], 0, 1)
    runner = tdp.make_node2vec_chunk_runner(config, opt, B, N)
    with pytest.raises(ValueError, match="with_update_mask=False"):
        runner(params, None, torch.tensor(-1.0), pairs, t(negs)[None], 0, 1,
               update_mask)


def test_init_statistics_match_jax():
    config = tn.Node2VecConfig(num_nodes=4001, dim=64)
    ours = tn.init_node2vec_params(torch.Generator().manual_seed(0), config)
    theirs = jax.device_get(jn.init_node2vec_params(
        jax.random.key(0), jn.Node2VecConfig(num_nodes=4001, dim=64)))
    std = 1.0 / np.sqrt(64)
    for k, lo, hi in (("target", -1.0, 1.0),
                      ("context", -2 * std, 2 * std)):
        a, b = ours[k].numpy(), np.asarray(theirs[k])
        assert a.shape == b.shape == (4001, 64) and a.dtype == np.float32
        assert lo <= a.min() and a.max() <= hi
        assert abs(a.mean() - b.mean()) < 0.01 * (hi - lo)
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.01)
    np.testing.assert_allclose(ours["target"].numpy().std(), 1 / np.sqrt(3),
                               rtol=0.01)
    # a normal cut at 2 std keeps 0.880 of its std
    np.testing.assert_allclose(ours["context"].numpy().std(), 0.880 * std,
                               rtol=0.01)
    assert (ours["bias"] == 0).all() and ours["bias"].shape == (4001,)
    again = tn.init_node2vec_params(torch.Generator().manual_seed(0), config)
    for k in ours:
        torch.testing.assert_close(ours[k], again[k], rtol=0, atol=0)


def test_bridge_round_trips_the_node2vec_tree():
    tree = jax.device_get(jn.init_node2vec_params(
        jax.random.key(1), jn.Node2VecConfig(num_nodes=21, dim=6)))
    flat = params_from_jax(tree)
    assert sorted(flat) == ["bias", "context", "target"]
    back = params_to_jax(flat)
    assert sorted(back) == sorted(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], np.asarray(tree[k]))
