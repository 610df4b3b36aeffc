"""The port's fused gather -> MLP -> pool (graphsage_tpu_torch/ops/pool.py)
against graphsage_tpu/ops/pool.py, and the meanpool slice as a whole
(training steps, the eval sweep, the CLI) against the JAX package.

On the CPU the port's wrappers run their plain versions (K5 and K6 run
only on a card: tests/test_torch_cuda.py). The JAX side runs its Pallas
kernel in interpret mode or its XLA reference. Inputs are made with
NumPy from a seed; the JAX table is padded to its kernel's 128 lanes
with ``pad_feature_dim``, the port's keeps its logical width.

Tolerances: pooled outputs rtol/atol 1e-5 (f32 sums in another order);
gradients rtol 1e-4, atol 1e-5, as tests/test_pool.py holds the JAX
custom VJP; params after Adam 1e-4 absolute (Adam divides by |g| + eps,
which amplifies last-bit gradient differences where |g| is near eps);
the dropout plain version against an explicit replica of its mask:
forward exact, gradients to f32 rounding (1e-6 relative).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.ops import pool as jpool
from graphsage_tpu.ops.gather import pad_feature_dim
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.train.supervised import _run_eval_sweep, make_eval_sweep
from graphsage_tpu_torch import infer
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.ops import pool
from graphsage_tpu_torch.ops.philox import dropout_keep_mask, dropout_scale
from graphsage_tpu_torch.parallel import dp as tdp
from graphsage_tpu_torch.train import checkpoint
from graphsage_tpu_torch.train.config import TrainFlags
from tests._torch_common import port_params, t

B, S, F, H = 12, 5, 100, 128
N = 40


@pytest.fixture(scope="module")
def setup():
    """tests/test_pool.py's operands: duplicate rows (max ties across
    neighbors) and an all-negative row (dead relu)."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    feats[7] = feats[3]
    feats[11] = -np.abs(feats[11]) - 1.0
    idx = rng.integers(0, N, (B, S)).astype(np.int32)
    idx[0, :] = 3       # every neighbor identical -> an S-way max tie
    idx[1, :2] = [3, 7]  # duplicate-feature neighbors -> a 2-way tie
    w = (rng.standard_normal((F, H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((H,)) * 0.1).astype(np.float32)
    return feats, idx, w, b


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_forward_matches_jax(setup, reduce):
    feats, idx, w, b = setup
    jargs = (jnp.asarray(pad_feature_dim(feats)), jnp.asarray(idx),
             jnp.asarray(w), jnp.asarray(b))
    kernel = jpool.fused_gather_mlp_pool(*jargs, reduce, interpret=True,
                                         tile_b=4)
    ref = jpool.gather_mlp_pool_reference(*jargs, reduce)
    targs = (t(feats), t(idx), t(w), t(b))
    out = pool.fused_gather_mlp_pool(*targs, reduce)
    assert out.shape == (B, H) and out.dtype == torch.float32
    for want in (kernel, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    pooled, x, mask = pool.gather_mlp_pool_with_rows(*targs, reduce)
    assert torch.equal(pooled, out)
    np.testing.assert_array_equal(x.numpy(), feats[idx.reshape(-1)])
    assert mask.shape == (B * S, H) and mask.dtype == torch.bool


@pytest.mark.parametrize("reduce", ["max", "mean"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_with_rows_is_pool_rows_and_relu_mask(setup, reduce, rate):
    """The plain route of K6's forward: (pooled, x, mask) is
    (pool_rows(x, ...), the dropped rows, x @ w + b > 0) bit for bit."""
    feats, idx, w, b = setup
    key = dict(seed=2**33 + 9, offset=(4, 0x5EED)) if rate else {}
    args = (t(feats), t(idx), t(w), t(b))
    pooled, x, mask = pool.gather_mlp_pool_with_rows(*args, reduce, rate,
                                                     **key)
    want_x = pool.gathered_rows_reference(t(feats), t(idx), rate, **key)
    assert torch.equal(x, want_x)
    assert torch.equal(pooled, pool.pool_rows(want_x, t(w), t(b), reduce, S))
    assert torch.equal(mask, want_x @ t(w) + t(b) > 0)
    assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_mean_backward_from_the_mask_is_the_recompute(setup, rate):
    """The mean's backward from the forward's mask equals, bit for bit,
    the route that recomputed z = x @ w + b for relu's mask."""
    feats, idx, w, b = setup
    key = dict(seed=31, offset=(2, 3)) if rate else {}
    _, x, mask = pool.gather_mlp_pool_with_rows(t(feats), t(idx), t(w), t(b),
                                                "mean", rate, **key)
    dy = t(np.random.default_rng(5).standard_normal((B, H)).astype(
        np.float32))
    z = x @ t(w) + t(b)
    dh = (dy[:, None, :] / S).expand(B, S, H).reshape(B * S, H)
    dz = torch.where(z > 0, dh, torch.zeros_like(dh))
    got = pool.route_pool_grad(dy, x, mask, t(w), t(b), "mean", S)
    assert torch.equal(got[0], x.t() @ dz)
    assert torch.equal(got[1], dz.sum(dim=0))


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_train_grads_match_jax(setup, reduce):
    """The autograd Function's backward (route_pool_grad from the saved
    rows) against jax.grad of gather_mlp_pool_train, the even tie split
    and relu' = 0 at z <= 0 included."""
    feats, idx, w, b = setup
    cot = np.random.default_rng(1).standard_normal((B, H)).astype(np.float32)
    features = jnp.asarray(pad_feature_dim(feats))

    def jax_loss(w_, b_):
        return jnp.sum(jpool.gather_mlp_pool_train(
            reduce, 0.0, features, jnp.asarray(idx), w_, b_) * cot)

    jw, jb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(w),
                                                jnp.asarray(b))
    tw, tb = t(w).requires_grad_(), t(b).requires_grad_()
    out = pool.gather_mlp_pool_train(t(feats), t(idx), tw, tb, reduce)
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-4,
                               atol=1e-5)
    with torch.no_grad():   # no gradient wanted: K5's path, the same value
        np.testing.assert_allclose(
            pool.gather_mlp_pool_train(t(feats), t(idx), tw, tb,
                                       reduce).numpy(),
            out.detach().numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_dropout_matches_mask_replica(setup, reduce):
    """The dropout plain version against an explicit replica built from
    dropout_keep_mask: the forward is exact and the (w, b) gradients are
    exact for the realised mask (cf. tests/test_pool.py:181)."""
    feats, idx, w, b = setup
    rate, seed, offset = 0.4, 2**40 + 5, (3, 0x5EED)
    cot = t(np.random.default_rng(3).standard_normal((B, H)).astype(
        np.float32))
    keep = dropout_keep_mask(B * S, F, rate, seed, *offset)
    assert 0.5 < float(keep.float().mean()) < 0.7

    def replica(w_, b_):
        x = t(feats)[t(idx).reshape(-1).long()]
        x = torch.where(keep, x * dropout_scale(rate), torch.zeros_like(x))
        h = torch.relu(x @ w_ + b_).view(B, S, H)
        return torch.amax(h, 1) if reduce == "max" else h.mean(1)

    w1, b1 = t(w).requires_grad_(), t(b).requires_grad_()
    w2, b2 = t(w).requires_grad_(), t(b).requires_grad_()
    out = pool.gather_mlp_pool_train(t(feats), t(idx), w1, b1, reduce, rate,
                                     seed, offset)
    ref = replica(w2, b2)
    assert torch.equal(out, ref)
    (out * cot).sum().backward()
    (ref * cot).sum().backward()
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(b1.grad.numpy(), b2.grad.numpy(), rtol=1e-6,
                               atol=1e-7)
    no_grad = pool.fused_gather_mlp_pool(t(feats), t(idx), t(w), t(b),
                                         reduce, rate, seed, offset)
    assert torch.equal(no_grad, ref.detach())


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_dropout_residual_invariant(setup, reduce):
    """pooled == pool(relu(X @ w + b)) for the dropped residual X, the
    invariant that makes the backward exact (cf. tests/test_pool.py:337);
    X is the gathered rows with the mask's zeros and 1/keep scale."""
    feats, idx, w, b = setup
    args = (t(feats), t(idx), t(w), t(b), reduce, 0.3, 77, (1, 2))
    pooled, x, mask = pool.gather_mlp_pool_with_rows(*args)
    np.testing.assert_allclose(
        pooled.numpy(), pool.pool_rows(x, t(w), t(b), reduce, S).numpy(),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(mask, x @ t(w) + t(b) > 0)
    rows = feats[idx.reshape(-1)]
    kept = x.numpy() != 0
    np.testing.assert_allclose(x.numpy()[kept], rows[kept] / 0.7, rtol=1e-6)
    assert 0.2 < 1 - kept.mean() < 0.4


def test_bf16_table_upcasts_rows():
    """A bf16 table's rows are upcast to f32 before the product, as the
    JAX package's reference (and its f32 fallback for bf16) does."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((20, 16)).astype(np.float32)
    feats16 = torch.from_numpy(feats).to(torch.bfloat16)
    idx = rng.integers(0, 20, (6, 3)).astype(np.int32)
    w = (rng.standard_normal((16, 24)) * 0.2).astype(np.float32)
    b = np.zeros(24, np.float32)
    ref = jpool.gather_mlp_pool_reference(
        jnp.asarray(feats, dtype=jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(w), jnp.asarray(b), "mean")
    out = pool.fused_gather_mlp_pool(feats16, t(idx), t(w), t(b), "mean")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(reduce="sum"), "reduce"),
    (dict(w=torch.zeros(5, 4)), "w must be"),
    (dict(idx=torch.zeros(2, 3, dtype=torch.int64)), "int32"),
    (dict(drop_rate=0.5), "seed and offset"),
    (dict(drop_rate=1.0), "drop_rate"),
])
def test_input_checks(bad, match):
    args = dict(features=torch.zeros(10, 6),
                idx=torch.zeros(2, 3, dtype=torch.int32),
                w=torch.zeros(6, 4), b=torch.zeros(4), reduce="max")
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        pool.fused_gather_mlp_pool(**args)


# ------------------------------------------------- the slice as a whole

LR = 0.01
TB = 16


def _sup_configs(g, aggregator, fused=True):
    kw = dict(feature_dim=g.feature_dim, aggregator=aggregator, concat=True,
              num_nodes=g.num_nodes, sampler_mode="first_k",
              fused_gather=fused)
    layers = ((4, 8), (3, 8))
    jcfg = js.SupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, d) for s, d in layers), **kw),
        num_classes=g.num_classes, weight_decay=0.001)
    tcfg = ts.SupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, d) for s, d in layers), **kw),
        num_classes=g.num_classes, weight_decay=0.001)
    return jcfg, tcfg


def test_meanpool_training_steps_match_jax():
    """Three steps of the chunk runner (meanpool, fused: the Function on
    the port's side, the custom VJP's XLA path on JAX's), params after
    each Adam step within 1e-4."""
    g = make_synthetic_graph(num_nodes=90, num_classes=3, feat_dim=8,
                             seed=7)
    feats = g.padded_features()
    _, _, adj = build_both_adjs(g, 8, seed=1)
    jcfg, tcfg = _sup_configs(g, "meanpool")
    rng = np.random.default_rng(3)
    ids_perm = np.full((3 * TB,), g.num_nodes, dtype=np.int32)
    ids_perm[: 3 * TB - 5] = rng.permutation(g.num_nodes)[: 3 * TB - 5]
    labels_table = np.zeros((g.num_nodes + 1, 3), dtype=np.float32)
    labels_table[: g.num_nodes] = g.labels

    jparams = js.init_supervised_params(jax.random.key(5), jcfg)
    jopt = js.make_optimizer(LR)
    jrun = jax.jit(jdp.make_supervised_chunk_runner(jcfg, jopt, TB))
    jstate = jopt.init(jparams)
    params = port_params(jparams)
    assert "aggs.0.mlp.0.w" in params
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    run = tdp.make_supervised_chunk_runner(tcfg, optimizer, TB)
    for i in range(3):
        jparams, jstate, jloss, _, _ = jrun(
            jparams, jstate, jax.random.key(0), jnp.asarray(feats),
            jnp.asarray(adj), jnp.asarray(ids_perm),
            jnp.asarray(labels_table), i, 1)
        params, opt_state, loss, _, _ = run(
            params, opt_state, None, t(feats), t(adj), t(ids_perm),
            t(labels_table), i, 1)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   err_msg=f"step {i}")
        want = port_params(jparams)
        for k, v in params.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                       atol=1e-4, err_msg=f"{k} step {i}")


def test_meanpool_eval_sweep_matches_jax(tmp_path):
    """``predict`` for graphsage_meanpool against the JAX package's eval
    sweep on the same dataset, adjacency and weights."""
    g = make_synthetic_graph(num_nodes=70, num_classes=3, feat_dim=8,
                             seed=11)
    flags = TrainFlags(train_prefix=str(tmp_path / "toy" / "toy"),
                       model="graphsage_meanpool", samples_1=4, samples_2=3,
                       dim_1=8, dim_2=8, max_degree=8, batch_size=16,
                       sampler_mode="first_k",
                       checkpoint_dir=str(tmp_path / "ck"),
                       base_log_dir=str(tmp_path), seed=5)
    write_dataset(g, flags.train_prefix)
    graph = load_data(flags.train_prefix)
    _, _, adj = build_both_adjs(graph, flags.max_degree, seed=flags.seed)
    jcfg, _ = _sup_configs(graph, "meanpool")
    jcfg = dataclasses.replace(jcfg, weight_decay=0.0)
    jparams = js.init_supervised_params(jax.random.key(3), jcfg)
    checkpoint.save(flags.checkpoint_dir, port_params(jparams), 9)
    nodes = np.arange(graph.num_nodes)
    jloss, jpreds, _, _ = _run_eval_sweep(
        make_eval_sweep(jcfg, flags.batch_size, graph.num_nodes), jparams,
        jnp.asarray(graph.padded_features()), jnp.asarray(adj), nodes,
        graph.labels, flags.batch_size, graph.num_nodes, jax.random.key(0))
    out = infer.predict(flags, out_dir=str(tmp_path / "out"), nodes="all",
                        device="cpu")
    preds = np.load(os.path.join(out["out_dir"], "preds.npy"))
    np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["loss"], jloss, rtol=1e-5, atol=1e-6)
