"""The port's supervised training slice against the JAX package: one
train step, a 5-step chunk, the optimizer-state bridge, the TF1 trace,
the node batcher and the ``supervised`` CLI, under the deterministic
first_k sampler with dropout 0 (JAX and torch draw different bits).

Tolerances: the loss of one step 1e-5; gradients 1e-4 relative and 1e-5
absolute; params after one Adam step 1e-4 absolute (Adam divides by
|g| + eps, which amplifies last-bit gradient differences where |g| is
near eps); per-step losses of the chunk 1e-4 and its final params 5e-4,
as the JAX suite holds its own multi-step trajectory
(tests/test_reference_traced.py)."""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.data.minibatch import NodeBatcher as JaxNodeBatcher
from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.train.config import TrainFlags as JaxTrainFlags
from graphsage_tpu_torch import cli
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.minibatch import NodeBatcher
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.params import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
)
from graphsage_tpu_torch.parallel import dp as tdp
from graphsage_tpu_torch.train import checkpoint
from graphsage_tpu_torch.train import supervised as tsup
from graphsage_tpu_torch.train.config import TrainFlags
from tests._torch_common import port_params, t

LR = 0.01
B = 16


@pytest.fixture(scope="module")
def toy():
    """(graph, padded features, train adjacency, full adjacency)."""
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             seed=7)
    train_adj, _, full_adj = build_both_adjs(g, 8, seed=1)
    return g, g.padded_features(), train_adj, full_adj


def _configs(num_nodes, aggregator="mean", sigmoid=False, weight_decay=0.0,
             identity_dim=0, layers=((4, 8), (3, 8)), num_classes=4,
             rows_gather=False):
    mult = 2 if aggregator == "gcn" else 1
    kw = dict(feature_dim=8, aggregator=aggregator,
              concat=aggregator != "gcn", identity_dim=identity_dim,
              num_nodes=num_nodes, sampler_mode="first_k", fused_gather=True,
              rows_gather=rows_gather)
    sup = dict(num_classes=num_classes, sigmoid_loss=sigmoid,
               weight_decay=weight_decay)
    jcfg = js.SupervisedConfig(sage=jg.SAGEConfig(
        layers=tuple(jg.LayerInfo(s, mult * d) for s, d in layers), **kw),
        **sup)
    tcfg = ts.SupervisedConfig(sage=tg.SAGEConfig(
        layers=tuple(tg.LayerInfo(s, mult * d) for s, d in layers), **kw),
        **sup)
    return jcfg, tcfg


def _batch(g, sigmoid, seed=0):
    """ids (ending in the dummy node), labels, mask."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.choice(g.num_nodes, B - 1, replace=False),
                          [g.num_nodes]]).astype(np.int32)
    if sigmoid:
        labels = (rng.random((B, 4)) < 0.4).astype(np.float32)
    else:
        labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, B)]
    return ids, labels, (ids != g.num_nodes).astype(np.float32)


def _assert_params_close(port: dict, jax_tree, atol, rtol=0.0):
    want = params_from_jax(jax.device_get(jax_tree))
    assert port.keys() == want.keys()
    for k, v in port.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("aggregator,sigmoid,weight_decay,identity_dim", [
    ("mean", False, 0.0, 0), ("gcn", False, 0.0, 0), ("mean", True, 0.0, 0),
    ("gcn", True, 0.0, 0), ("mean", False, 0.01, 0), ("mean", False, 0.0, 4),
    ("gcn", False, 0.01, 4), ("meanpool", False, 0.0, 0),
    ("meanpool", True, 0.01, 0), ("maxpool", False, 0.01, 0),
    ("meanpool", False, 0.0, 4),
])
def test_train_step_matches_jax(toy, aggregator, sigmoid, weight_decay,
                                identity_dim):
    _check_train_step(toy, *_configs(toy[0].num_nodes, aggregator, sigmoid,
                                     weight_decay, identity_dim), sigmoid)


@pytest.mark.parametrize("sigmoid,weight_decay,identity_dim", [
    (False, 0.0, 0), (True, 0.01, 0), (False, 0.0, 4),
])
def test_seq_rows_gather_train_step_matches_jax(toy, sigmoid, weight_decay,
                                                identity_dim):
    """graphsage_seq with rows_gather (K4's plain version gathers the
    innermost hop's rows; the JAX side takes them with jnp.take): the
    loss, every gradient (the LSTM's included) and the params after one
    Adam step, at the tolerances above."""
    _check_train_step(toy, *_configs(toy[0].num_nodes, "seq", sigmoid,
                                     weight_decay, identity_dim,
                                     rows_gather=True), sigmoid)


def _check_train_step(toy, jcfg, tcfg, sigmoid):
    g, feats, adj, _ = toy
    ids, labels, mask = _batch(g, sigmoid)
    jparams = js.init_supervised_params(jax.random.key(2), jcfg)
    args = (jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(ids),
            jnp.asarray(labels), jnp.asarray(mask))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: js.supervised_loss(p, *args, jax.random.key(0), jcfg,
                                     deterministic=False), has_aux=True,
    )(jparams)
    jopt = js.make_optimizer(LR)
    jnew, _, jstep_loss, _ = jdp.make_supervised_train_step(jcfg, jopt)(
        jparams, jopt.init(jparams), jax.random.key(0), *args)

    params = port_params(jparams)
    targs = (t(feats), t(adj), t(ids), t(labels), t(mask))
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    loss, _ = ts.supervised_loss(params, *targs, tcfg, deterministic=False)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=1e-5)
    _assert_params_close(grads, jgrads, atol=1e-5, rtol=1e-4)

    step = tdp.make_supervised_train_step(tcfg, optimizer)
    params, opt_state, step_loss, logits = step(
        params, opt_state, None, *targs)
    assert logits.shape == (B, 4) and not step_loss.requires_grad
    np.testing.assert_allclose(float(step_loss), float(jstep_loss), atol=1e-5)
    _assert_params_close(params, jnew, atol=1e-4)


def test_chunk_runner_matches_jax(toy):
    """5 steps over one numpy id stream (with a dummy-padded tail), each
    run as its own chunk on both sides so that every loss is seen."""
    g, feats, adj, _ = toy
    jcfg, tcfg = _configs(g.num_nodes, weight_decay=0.001)
    rng = np.random.default_rng(3)
    ids_perm = np.full((5 * B,), g.num_nodes, dtype=np.int32)
    ids_perm[: 5 * B - 7] = rng.permutation(g.num_nodes)[: 5 * B - 7]
    labels_table = np.zeros((g.num_nodes + 1, 4), dtype=np.float32)
    labels_table[: g.num_nodes] = g.labels

    jparams = js.init_supervised_params(jax.random.key(5), jcfg)
    jopt = js.make_optimizer(LR)
    jrun = jax.jit(jdp.make_supervised_chunk_runner(jcfg, jopt, B))
    params = port_params(jparams)
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    run = tdp.make_supervised_chunk_runner(tcfg, optimizer, B)

    jstate = jopt.init(jparams)
    for i in range(5):
        jparams, jstate, jloss, _, jids = jrun(
            jparams, jstate, jax.random.key(0), jnp.asarray(feats),
            jnp.asarray(adj), jnp.asarray(ids_perm),
            jnp.asarray(labels_table), i, 1)
        params, opt_state, loss, logits, last_ids = run(
            params, opt_state, None, t(feats), t(adj), t(ids_perm),
            t(labels_table), i, 1)
        np.testing.assert_array_equal(last_ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4,
                                   err_msg=f"step {i}")
    _assert_params_close(params, jparams, atol=5e-4)
    with pytest.raises(ValueError, match="n_steps"):
        run(params, opt_state, None, t(feats), t(adj), t(ids_perm),
            t(labels_table), 0, 0)


def test_optimizer_state_bridge(toy):
    """A JAX run continues in the port: one JAX step, bridge params and
    Adam state, then one more step on each side."""
    g, feats, adj, _ = toy
    jcfg, tcfg = _configs(g.num_nodes, identity_dim=4)
    jopt = js.make_optimizer(LR)
    jstep = jax.jit(jdp.make_supervised_train_step(jcfg, jopt))
    jparams = js.init_supervised_params(jax.random.key(6), jcfg)
    jstate = jopt.init(jparams)
    batches = [_batch(g, False, seed=s) for s in (1, 2)]
    for i, (ids, labels, mask) in enumerate(batches):
        jparams, jstate, _, _ = jstep(
            jparams, jstate, jax.random.key(0), jnp.asarray(feats),
            jnp.asarray(adj), jnp.asarray(ids), jnp.asarray(labels),
            jnp.asarray(mask))
        if i == 0:
            first = jax.device_get((jparams, jstate))

    params = params_from_jax(first[0])
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    bridged = opt_state_from_jax(first[1])
    assert bridged["count"] == 1
    optimizer.load_state_dict(opt_state, params, bridged)
    ids, labels, mask = batches[1]
    tdp.make_supervised_train_step(tcfg, optimizer)(
        params, opt_state, None, t(feats), t(adj), t(ids), t(labels),
        t(mask))
    _assert_params_close(params, jparams, atol=1e-4)

    # and back: the port's state in optax's structure
    back = opt_state_to_jax(optimizer.state_dict(opt_state, params),
                            jax.device_get(jstate))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.device_get(jstate))
    assert int(back[1][0].count) == 2
    for a, b in zip(jax.tree_util.tree_leaves(back[1][0].mu),
                    jax.tree_util.tree_leaves(jstate[1][0].mu)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-5)


def test_require_num_nodes():
    _, tcfg = _configs(0)
    with pytest.raises(ValueError, match="num_nodes must be set"):
        tdp.make_supervised_chunk_runner(tcfg, ts.make_optimizer(LR), B)
    with pytest.raises(ValueError, match="id stream"):
        tdp._require_num_nodes(0, "id stream")
    tdp._require_num_nodes(1)


# -------------------------------------------------- the TF1 trace

FIX = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                           "reference_traced.npz"))
TF_NAMES = {"neigh_w": "neigh_weights", "self_w": "self_weights",
            "w": "weights", "b": "bias"}


def _tf_key(port_key: str) -> str:
    """aggs.0.neigh_w -> agg0_neigh_weights; head.w -> head_weights."""
    parts = port_key.split(".")
    if parts[0] == "aggs":
        return f"agg{parts[1]}_{TF_NAMES[parts[2]]}"
    if parts[0] == "head":
        return "head_" + {"w": "weights", "b": "bias"}[parts[1]]
    return port_key


@pytest.mark.parametrize("case,agg,sigmoid,wd,id_dim", [
    ("sup_mean_softmax", "mean", False, 0.0, 0),
    ("sup_mean_sigmoid", "mean", True, 0.0, 0),
    ("sup_mean_wd", "mean", False, 0.01, 0),
    ("sup_gcn", "gcn", False, 0.0, 0),
    ("sup_identity", "mean", False, 0.0, 3),
    ("sup_mean_3layer", "mean", False, 0.0, 0),
])
def test_supervised_model_matches_tf1_trace(case, agg, sigmoid, wd, id_dim):
    """Loss and every gradient against the reference TF1 code's traced
    numbers, at the JAX suite's tolerances (loss 1e-5, grads 1e-4)."""
    def g(name):
        return FIX[f"{case}/{name}"]

    n_layers = 3 if case.endswith("3layer") else 2
    layers = (tg.LayerInfo(3, 6), tg.LayerInfo(2, 6),
              tg.LayerInfo(2, 6))[:n_layers]
    config = ts.SupervisedConfig(
        sage=tg.SAGEConfig(layers=layers, feature_dim=8, aggregator=agg,
                           concat=agg != "gcn", identity_dim=id_dim,
                           num_nodes=12, sampler_mode="first_k",
                           fused_gather=True),
        num_classes=5, sigmoid_loss=sigmoid, weight_decay=wd)
    params = {}
    for li in range(n_layers):
        for ours, tf in TF_NAMES.items():
            if f"{case}/var_agg{li}_{tf}" in FIX.files:
                params[f"aggs.{li}.{ours}"] = t(g(f"var_agg{li}_{tf}"))
    params["head.w"] = t(g("var_head_weights"))
    params["head.b"] = t(g("var_head_bias"))
    if id_dim:
        params["embeds"] = t(g("var_embeds"))
    for p in params.values():
        p.requires_grad_(True)
    ids = t(FIX["graph/batch"])
    loss, logits = ts.supervised_loss(
        params, t(FIX["graph/features"]), t(FIX["graph/adj"]), ids,
        t(g("labels")), torch.ones(ids.shape[0]), config,
        deterministic=True)
    np.testing.assert_allclose(logits.detach().numpy(), g("logits"),
                               atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), g("loss"), atol=1e-5,
                               rtol=1e-5)
    for k, grad in zip(params, grads):
        np.testing.assert_allclose(grad.numpy(), g(f"grad_{_tf_key(k)}"),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


# ------------------------------------------------ batcher and loop

def test_node_batcher_matches_jax(toy):
    g, _, _, _ = toy
    _, deg, _ = build_both_adjs(g, 8, seed=1)
    ours, theirs = NodeBatcher(g, deg, B, seed=4), JaxNodeBatcher(g, deg, B,
                                                                  seed=4)
    for name in ("train_nodes", "val_nodes", "test_nodes"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    assert ours.num_batches() == theirs.num_batches()
    for size in (7, 5):
        a, b = ours.sample_val_batch(size), theirs.sample_val_batch(size)
        for name in ("ids", "labels", "mask"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_gather_flags_reach_config(toy):
    """--dedup_gather and --rows_gather reach SAGEConfig through
    build_supervised_config (tests/test_train.py's check), for both
    subcommands' parsers; both default to off."""
    g = toy[0]
    f = TrainFlags(train_prefix="/x/x", model="graphsage_maxpool",
                   rows_gather=True, dedup_gather=True)
    sage = tsup.build_supervised_config(f, g).sage
    assert sage.rows_gather and sage.dedup_gather
    sage0 = tsup.build_supervised_config(TrainFlags(train_prefix="/x/x"),
                                         g).sage
    assert not sage0.rows_gather and not sage0.dedup_gather
    for command in ("supervised", "predict"):
        args = cli.build_parser().parse_args(
            [command, "--train_prefix", "x", "--rows_gather",
             "--dedup_gather"])
        assert args.rows_gather and args.dedup_gather
        args = cli.build_parser().parse_args(
            [command, "--train_prefix", "x", "--no-rows_gather"])
        assert not args.rows_gather and not args.dedup_gather


def test_train_flags_defaults_match_jax():
    ours, theirs = TrainFlags(), JaxTrainFlags()
    for f in dataclasses.fields(ours):
        if f.name != "checkpoint_dir":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


STATS = re.compile(r"loss=\d+\.\d{5} f1_micro=\d\.\d{5} f1_macro=\d\.\d{5}")


def test_cli_supervised_trains_and_resumes(tmp_path, capsys):
    """Loss falls over 2 epochs, the stats files have the JAX package's
    format, and --resume continues from the saved step with the saved
    Adam moments."""
    g = make_synthetic_graph(num_nodes=200, num_classes=3, feat_dim=8,
                             seed=2)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    argv = ["supervised", "--train_prefix", prefix, "--samples_1", "4",
            "--samples_2", "3", "--dim_1", "8", "--dim_2", "8",
            "--max_degree", "8", "--batch_size", "16", "--print_every", "1",
            "--validate_iter", "4", "--validate_batch_size", "8",
            "--base_log_dir", str(tmp_path), "--checkpoint_dir",
            str(tmp_path / "ck"), "--dropout", "0.2", "--device", "cpu"]
    assert cli.main(argv + ["--epochs", "2"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"train_loss= (\S+)", out)]
    steps_per_epoch = out.count("Iter:") // 2
    assert steps_per_epoch >= 5
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    log_dir = tmp_path / "sup-toy" / "graphsage_mean_small_0.0100"
    assert STATS.fullmatch(
        (log_dir / "test_stats.txt").read_text())
    assert re.fullmatch(STATS.pattern + r" time=\d+\.\d{5}",
                        (log_dir / "val_stats.txt").read_text())
    records = [json.loads(x) for x in
               (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert "final_val_loss" in records[-1]

    saved, opt_state, step = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert step == 2 * steps_per_epoch and opt_state["count"] == step
    assert cli.main(argv + ["--epochs", "1", "--resume"]) == 0
    assert f"Resumed from checkpoint at step {step}" in \
        capsys.readouterr().out
    _, opt_state, step2 = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert step2 == step + steps_per_epoch and opt_state["count"] == step2


def test_params_only_checkpoint_still_serves(tmp_path):
    """A checkpoint without optimizer state (the serving slice's format)
    restores for predict and resumes training from zero moments."""
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=2)
    flags = TrainFlags(train_prefix=str(tmp_path / "toy" / "toy"),
                       samples_1=4, samples_2=3, dim_1=8, dim_2=8,
                       max_degree=8, batch_size=16, sampler_mode="first_k",
                       checkpoint_dir=str(tmp_path / "ck"), epochs=1,
                       base_log_dir=str(tmp_path), resume=True)
    params = ts.init_supervised_params(
        torch.Generator().manual_seed(0),
        tsup.build_supervised_config(flags, g))
    os.makedirs(flags.checkpoint_dir)
    torch.save({"params": params, "step": 3},
               os.path.join(flags.checkpoint_dir, "step_0000000003.pt"))
    restored, step = checkpoint.restore(flags.checkpoint_dir)
    assert step == 3 and restored.keys() == params.keys()
    assert checkpoint.restore_train_state(flags.checkpoint_dir)[1] is None
    _, deg, _ = build_both_adjs(g, flags.max_degree, seed=flags.seed)
    steps = NodeBatcher(g, deg, flags.batch_size).num_batches()
    assert tsup.train(flags, graph=g, device="cpu")["steps"] == 3 + steps


def test_train_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsup.train(TrainFlags(train_prefix=str(tmp_path / "x" / "x")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["supervised", "--train_prefix", str(tmp_path / "x")])


def test_cli_supervised_meanpool_trains_and_resumes(tmp_path, capsys):
    """--model graphsage_meanpool through the CLI on the CPU (the fused
    pool path, dropout 0.2): the loss falls, and --resume continues with
    the MLP weights and their Adam moments from the checkpoint."""
    g = make_synthetic_graph(num_nodes=120, num_classes=3, feat_dim=8,
                             seed=4)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    argv = ["supervised", "--train_prefix", prefix, "--model",
            "graphsage_meanpool", "--samples_1", "4", "--samples_2", "3",
            "--dim_1", "8", "--dim_2", "8", "--max_degree", "8",
            "--batch_size", "16", "--print_every", "1", "--validate_iter",
            "3", "--validate_batch_size", "8", "--base_log_dir",
            str(tmp_path), "--checkpoint_dir", str(tmp_path / "ck"),
            "--dropout", "0.2", "--learning_rate", "0.003", "--device",
            "cpu"]
    assert cli.main(argv + ["--epochs", "3"]) == 0
    losses = [float(x) for x in re.findall(r"train_loss= (\S+)",
                                           capsys.readouterr().out)]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    log_dir = tmp_path / "sup-toy" / "graphsage_meanpool_small_0.0030"
    assert STATS.fullmatch((log_dir / "test_stats.txt").read_text())

    saved, opt_state, step = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert saved["aggs.0.mlp.0.w"].shape == (8, 512)
    assert opt_state["mu"]["aggs.1.mlp.0.w"].shape == (16, 512)
    assert float(opt_state["nu"]["aggs.0.mlp.0.w"].abs().max()) > 0
    assert cli.main(argv + ["--epochs", "1", "--resume"]) == 0
    assert f"Resumed from checkpoint at step {step}" in \
        capsys.readouterr().out
    resumed, opt_state2, step2 = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert step2 > step and opt_state2["count"] == step2
    assert not torch.equal(resumed["aggs.0.mlp.0.w"], saved["aggs.0.mlp.0.w"])


def test_cli_supervised_seq_rows_gather_trains_and_resumes(tmp_path, capsys):
    """--model graphsage_seq --rows_gather through the CLI on the CPU:
    the loss falls, and --resume continues with the LSTM's weights and
    their Adam moments (aggs.{i}.lstm.{kernel,bias}) from the
    checkpoint."""
    g = make_synthetic_graph(num_nodes=120, num_classes=3, feat_dim=8,
                             seed=4)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    argv = ["supervised", "--train_prefix", prefix, "--model",
            "graphsage_seq", "--rows_gather", "--samples_1", "4",
            "--samples_2", "3", "--dim_1", "8", "--dim_2", "8",
            "--max_degree", "8", "--batch_size", "16", "--print_every", "1",
            "--validate_iter", "3", "--validate_batch_size", "8",
            "--base_log_dir", str(tmp_path), "--checkpoint_dir",
            str(tmp_path / "ck"), "--learning_rate", "0.003", "--device",
            "cpu"]
    assert cli.main(argv + ["--epochs", "3"]) == 0
    losses = [float(x) for x in re.findall(r"train_loss= (\S+)",
                                           capsys.readouterr().out)]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    log_dir = tmp_path / "sup-toy" / "graphsage_seq_small_0.0030"
    assert STATS.fullmatch((log_dir / "test_stats.txt").read_text())

    saved, opt_state, step = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert saved["aggs.0.lstm.kernel"].shape == (8 + 128, 512)
    assert opt_state["mu"]["aggs.1.lstm.kernel"].shape == (16 + 128, 512)
    assert float(opt_state["nu"]["aggs.0.lstm.kernel"].abs().max()) > 0
    assert cli.main(argv + ["--epochs", "1", "--resume"]) == 0
    assert f"Resumed from checkpoint at step {step}" in \
        capsys.readouterr().out
    resumed, opt_state2, step2 = checkpoint.restore_train_state(
        str(tmp_path / "ck"))
    assert step2 > step and opt_state2["count"] == step2
    assert not torch.equal(resumed["aggs.0.lstm.kernel"],
                           saved["aggs.0.lstm.kernel"])
