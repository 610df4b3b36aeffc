"""The port's unsupervised training slice: the chunk runner (against
itself one step at a time, and against the JAX package's train step
given the same negatives), the train-MRR EMA, the validation sweep and
the embed sweep against the JAX package's, the trainer end to end on
the CPU with its export, checkpoints and ``--resume``, ``embed``
reproducing the trainer's ``val.npy`` bit for bit, and the
``unsupervised``, ``embed`` and ``walks`` subcommands. Sampling is
first_k with dropout 0 wherever the two packages are compared.

Tolerances: the eval and embed sweeps 1e-5; per-step losses 1e-4 and
params after the steps 5e-4, as tests/test_torch_train.py holds the
supervised chunk (Adam divides by |g| + eps); MRR 1e-5.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu import cli as jcli
from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.models import unsupervised as ju
from graphsage_tpu.nn import prediction as jp
from graphsage_tpu.parallel import dp as jdp
from graphsage_tpu.train import unsupervised as jtu
from graphsage_tpu_torch import cli
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.data.walks import run_random_walks
from graphsage_tpu_torch.infer import export_embeddings
from graphsage_tpu_torch.models import graphsage as tg
from graphsage_tpu_torch.models import supervised as ts
from graphsage_tpu_torch.models import unsupervised as tu
from graphsage_tpu_torch.nn.negative import unigram_cdf
from graphsage_tpu_torch.parallel import dp as tdp
from graphsage_tpu_torch.params import params_from_jax
from graphsage_tpu_torch.train import checkpoint
from graphsage_tpu_torch.train import unsupervised as tun
from graphsage_tpu_torch.train.config import TrainFlags
from tests._torch_common import port_params, t

B, N_NEG, LR = 8, 4, 0.01
LAYERS = ((3, 6), (2, 6))


@pytest.fixture(scope="module")
def toy():
    """(graph, padded features, train adjacency, full adjacency, train
    degrees)."""
    g = make_synthetic_graph(num_nodes=100, num_classes=3, feat_dim=8,
                             seed=6)
    train_adj, deg, full_adj = build_both_adjs(g, 6, seed=1)
    return g, g.padded_features(), train_adj, full_adj, deg


def _configs(num_nodes, aggregator="mean", dropout=0.0, weight_decay=0.0):
    kw = dict(feature_dim=8, aggregator=aggregator, concat=True,
              num_nodes=num_nodes, sampler_mode="first_k",
              fused_gather=True, dropout=dropout)
    return (ju.UnsupervisedConfig(sage=jg.SAGEConfig(
                layers=tuple(jg.LayerInfo(*li) for li in LAYERS), **kw),
                neg_sample_size=N_NEG, weight_decay=weight_decay),
            tu.UnsupervisedConfig(sage=tg.SAGEConfig(
                layers=tuple(tg.LayerInfo(*li) for li in LAYERS), **kw),
                weight_decay=weight_decay))


def _stream(g, deg, n_steps, seed=3):
    """A dummy-padded pair stream of n_steps batches (edges with both
    endpoints of positive train degree, the last batch short) and one
    row of negatives per step, drawn from the unigram CDF of the nodes
    that are no pair's target: a positive equal to a negative ties it,
    which the two packages' products may round either way."""
    rng = np.random.default_rng(seed)
    edges = g.edges[(deg[g.edges[:, 0]] > 0) & (deg[g.edges[:, 1]] > 0)]
    pairs = np.full((n_steps * B, 2), g.num_nodes, dtype=np.int32)
    k = n_steps * B - 3
    pairs[:k] = edges[rng.permutation(len(edges))[:k]]
    neg_deg = deg.copy()
    neg_deg[pairs[:k, 1]] = 0
    cdf = unigram_cdf(neg_deg)
    negs = np.clip(np.searchsorted(cdf, rng.random((n_steps, N_NEG),
                                                   dtype=np.float32)),
                   0, len(cdf) - 1).astype(np.int32)
    return pairs, negs


def _assert_params_close(port: dict, jax_tree, atol):
    want = params_from_jax(jax.device_get(jax_tree))
    assert port.keys() == want.keys()
    for k, v in port.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("aggregator,dropout", [("mean", 0.3),
                                                ("meanpool", 0.3)])
def test_chunk_of_n_steps_equals_n_chunks(toy, aggregator, dropout):
    """With dropout (K2's or K6's plain masks keyed by (seed, step), the
    rest from the generator) one chunk of 4 steps and 4 chunks of one
    step give the same params, loss, MRR and EMA, bit for bit."""
    g, feats, adj, _, deg = toy
    _, cfg = _configs(g.num_nodes, aggregator, dropout, weight_decay=0.01)
    pairs, negs = _stream(g, deg, 4)
    out = []
    for chunks in ([4], [1, 1, 1, 1]):
        params = tu.init_unsupervised_params(
            torch.Generator().manual_seed(0), cfg)
        optimizer = ts.make_optimizer(LR)
        opt_state = optimizer.init(params)
        run = tdp.make_unsupervised_chunk_runner(cfg, optimizer, B)
        gen = torch.Generator().manual_seed(5)
        shadow, step = torch.tensor(-1.0), 0
        for n in chunks:
            params, opt_state, shadow, loss, mrr = run(
                params, opt_state, shadow, gen, t(feats), t(adj), t(pairs),
                t(negs), step, n, drop_seed=77)
            step += n
        out.append((params, shadow, loss, mrr))
    (p4, s4, l4, m4), (p1, s1, l1, m1) = out
    for k in p4:
        assert torch.equal(p4[k], p1[k]), k
    assert torch.equal(s4, s1) and torch.equal(l4, l1) and torch.equal(m4,
                                                                       m1)
    assert 0.0 < float(m4) <= 1.0 and 0.0 < float(s4) <= 1.0


def test_runner_matches_jax_train_steps(toy, monkeypatch):
    """3 steps of the port's runner against 3 JAX train steps, each
    given the step's negatives: every loss and MRR, and the params."""
    g, feats, adj, _, deg = toy
    jcfg, tcfg = _configs(g.num_nodes, weight_decay=0.001)
    pairs, negs = _stream(g, deg, 3)
    step_negs = {}
    monkeypatch.setattr(ju, "sample_negatives",
                        lambda rng, cdf, n: jnp.asarray(step_negs["ids"]))
    jparams = ju.init_unsupervised_params(jax.random.key(4), jcfg)
    jopt = js.make_optimizer(LR)
    jstate = jopt.init(jparams)
    jstep = jdp.make_unsupervised_train_step(jcfg, jopt)
    params = port_params(jparams)
    optimizer = ts.make_optimizer(LR)
    opt_state = optimizer.init(params)
    run = tdp.make_unsupervised_chunk_runner(tcfg, optimizer, B)
    shadow = torch.tensor(-1.0)
    for i in range(3):
        b = pairs[i * B:(i + 1) * B]
        step_negs["ids"] = negs[i]
        jparams, jstate, jloss, jaux = jstep(
            jparams, jstate, jax.random.key(0), jnp.asarray(feats),
            jnp.asarray(adj), jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]),
            jnp.asarray((b[:, 0] != g.num_nodes).astype(np.float32)), None)
        params, opt_state, shadow, loss, mrr = run(
            params, opt_state, shadow, None, t(feats), t(adj), t(pairs),
            t(negs), i, 1)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(mrr), float(jaux["mrr"]),
                                   atol=1e-5, err_msg=f"step {i}")
    _assert_params_close(params, jparams, atol=5e-4)
    with pytest.raises(ValueError, match="n_steps"):
        run(params, opt_state, shadow, None, t(feats), t(adj), t(pairs),
            t(negs), 0, 0)


def test_train_mrr_ema_matches_jax_formula():
    """The sentinel and the 0.99 EMA of the JAX runner's carry
    (graphsage_tpu/parallel/dp.py:185-187) over a given MRR sequence."""
    mrrs = [0.3, 0.5, 0.1, 0.7, 0.7, 0.25]
    shadow, jshadow = torch.tensor(-1.0), jnp.asarray(-1.0)
    for m in mrrs:
        shadow = tdp.mrr_ema(shadow, torch.tensor(m))
        jshadow = jnp.where(jshadow < 0, m,
                            jshadow - (1 - 0.99) * (jshadow - m))
        np.testing.assert_allclose(float(shadow), float(jshadow), atol=1e-7)
    assert float(tdp.mrr_ema(torch.tensor(-1.0), torch.tensor(0.4))) == \
        pytest.approx(0.4)


def test_require_num_nodes():
    _, cfg = _configs(0)
    with pytest.raises(ValueError, match="pair stream"):
        tdp.make_unsupervised_chunk_runner(cfg, ts.make_optimizer(LR), B)


def test_eval_sweep_matches_jax_loop(toy):
    """The port's sweep over all val pairs against a loop of JAX
    sage_embed + edge_pred_loss with the same negatives: the mean loss
    and MRR over the real pairs. No negative is a val pair's target: a
    positive equal to a negative is a tie that the two packages' dot
    products may round either way."""
    g, feats, _, adj, deg = toy
    jcfg, tcfg = _configs(g.num_nodes)
    jparams = ju.init_unsupervised_params(jax.random.key(8), jcfg)
    val = g.edges[g.train_removed].astype(np.int32)
    assert len(val) % B != 0
    padded = tun.pad_pairs(val, B, g.num_nodes)
    negs = np.random.default_rng(2).choice(
        np.setdiff1d(np.flatnonzero(deg > 0), val[:, 1]), (1, N_NEG)
    ).astype(np.int32)
    loss, mrr = tun.make_unsup_eval_sweep(tcfg, B)(
        port_params(jparams), t(feats), t(adj), t(padded), t(negs[0]))

    sums = np.zeros(3)
    for i in range(len(padded) // B):
        b = padded[i * B:(i + 1) * B]
        mask = (b[:, 0] != g.num_nodes).astype(np.float32)
        ids = np.concatenate([b[:, 0], b[:, 1], negs[0]])
        out = jg.l2_normalize(jg.sage_embed(
            jparams, jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(ids),
            jax.random.key(0), jcfg.sage, True), 1)
        o1, o2, ng = out[:B], out[B:2 * B], out[2 * B:]
        jl = jp.edge_pred_loss(o1, o2, ng, mask=jnp.asarray(mask)) / max(
            mask.sum(), 1.0)
        _, jm = jp.mrr_and_ranks(jp.affinity(o1, o2), jp.neg_cost(o1, ng),
                                 jnp.asarray(mask))
        sums += [float(jl) * mask.sum(), float(jm) * mask.sum(), mask.sum()]
    np.testing.assert_allclose(float(loss), sums[0] / sums[2], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(mrr), sums[1] / sums[2], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("aggregator", ["mean", "meanpool"])
def test_embed_sweep_matches_jax(toy, aggregator):
    """Every node's l2-normalised embedding, the port's sweep against
    the JAX package's, with the same weights."""
    g, feats, _, adj, _ = toy
    jcfg, tcfg = _configs(g.num_nodes, aggregator)
    jparams = ju.init_unsupervised_params(jax.random.key(9), jcfg)
    rows = tun.embed_all_nodes(tcfg, B, port_params(jparams), t(feats),
                               t(adj), seed=1)
    n_b = -(-g.num_nodes // B)
    ids = np.full(n_b * B, g.num_nodes, np.int32)
    ids[:g.num_nodes] = np.arange(g.num_nodes)
    want = np.asarray(jtu.make_embed_sweep(jcfg, B, g.num_nodes)(
        jparams, jnp.asarray(feats), jnp.asarray(adj), jnp.asarray(ids),
        jax.random.key(1)))[:g.num_nodes]
    assert rows.shape == want.shape == (g.num_nodes, 12)
    np.testing.assert_allclose(rows, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------ the trainer

def _flags(tmp_path, **kw):
    base = dict(train_prefix=str(tmp_path / "toy" / "toy"), samples_1=3,
                samples_2=2, dim_1=6, dim_2=6, max_degree=6, batch_size=B,
                neg_sample_size=N_NEG, learning_rate=LR, epochs=1,
                print_every=3, validate_iter=4, validate_batch_size=5,
                random_context=False, base_log_dir=str(tmp_path),
                checkpoint_dir=str(tmp_path / "ck"), sampler_mode="first_k",
                max_total_steps=9, seed=3)
    base.update(kw)
    return TrainFlags(**base)


def test_trainer_exports_and_resumes(tmp_path, capsys):
    g = make_synthetic_graph(num_nodes=80, num_classes=3, feat_dim=8, seed=2)
    flags = _flags(tmp_path)
    result = tun.train(flags, graph=g, device="cpu")
    out = capsys.readouterr().out
    assert result["steps"] == 10 and "Optimization Finished!" in out
    lines = re.findall(r"Iter: \d{4} train_loss= \S+ train_mrr= \S+ "
                       r"train_mrr_ema= \S+ val_loss= \S+ val_mrr= \S+ "
                       r"val_mrr_ema= \S+ time= \S+", out)
    assert len(lines) == 4
    log_dir = result["log_dir"]
    assert log_dir.endswith(os.path.join("unsup-toy",
                                         "graphsage_mean_small_0.010000"))
    rows = np.load(os.path.join(log_dir, "val.npy"))
    assert rows.shape == (g.num_nodes, 12) and rows.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0,
                               atol=1e-5)
    with open(os.path.join(log_dir, "val.txt")) as fp:
        assert fp.read().splitlines() == [str(i) for i in g.node_ids]
    recs = [json.loads(x) for x in open(os.path.join(log_dir,
                                                     "metrics.jsonl"))]
    assert {"train_loss", "train_mrr", "train_mrr_ema", "val_loss",
            "val_mrr", "val_mrr_ema", "step_time"} <= recs[-1].keys()
    assert 0.0 < result["shadow_mrr"] <= 1.0
    assert 0.0 < result["train_mrr_ema"] <= 1.0

    _, opt_state, step = checkpoint.restore_train_state(flags.checkpoint_dir)
    assert step == 10 and opt_state["count"] == 10
    # --resume: continues from step 10 with Adam's moments, and a full
    # validation sweep (validate_batch_size -1)
    flags2 = dataclasses.replace(flags, resume=True, max_total_steps=14,
                                 validate_batch_size=-1)
    result2 = tun.train(flags2, graph=g, device="cpu")
    assert "Resumed from checkpoint at step 10" in capsys.readouterr().out
    assert result2["steps"] == 15
    _, opt_state, step = checkpoint.restore_train_state(flags.checkpoint_dir)
    assert step == 15 and opt_state["count"] == 15
    assert result2["val_loss"] > 0.0 and 0.0 < result2["val_mrr"] <= 1.0


def test_embed_reproduces_trainer_export(tmp_path):
    """export_embeddings from the trainer's checkpoint: the trainer's
    val.npy bit for bit (as tests/test_infer.py holds the JAX pair)."""
    g = make_synthetic_graph(num_nodes=80, num_classes=3, feat_dim=8, seed=2)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    flags = _flags(tmp_path, sampler_mode="shared_perm", model="gcn")
    result = tun.train(flags, device="cpu")
    trainer_rows = np.load(os.path.join(result["log_dir"], "val.npy"))
    out = export_embeddings(flags, out_dir=str(tmp_path / "re"),
                            device="cpu")
    np.testing.assert_array_equal(np.load(os.path.join(out, "val.npy")),
                                  trainer_rows)
    with open(os.path.join(out, "val.txt")) as fp:
        assert fp.read().splitlines() == [str(i) for i in g.node_ids]


def test_cli_walks_unsupervised_embed(tmp_path, capsys):
    """``walks`` writes the walks file, ``unsupervised`` trains on it
    (the default random_context) and ``embed`` reproduces its val.npy,
    all with --device cpu."""
    g = make_synthetic_graph(num_nodes=120, num_classes=3, feat_dim=8,
                             seed=3)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    assert cli.main(["walks", prefix + "-G.json", prefix + "-walks.txt",
                     "--num_walks", "3", "--walk_len", "4", "--seed", "2",
                     "--device", "cpu"]) == 0
    nodes = np.flatnonzero(g.is_train)
    is_train = g.is_train
    want = run_random_walks(
        [nb[is_train[nb]] if is_train[i] else nb[:0]
         for i, nb in enumerate(g.neighbors)], nodes, 3, 4,
        np.random.default_rng(2))
    with open(prefix + "-walks.txt") as fp:
        assert len(fp.read().splitlines()) == len(want) > 0
    common = ["--train_prefix", prefix, "--samples_1", "3", "--samples_2",
              "2", "--dim_1", "6", "--dim_2", "6", "--max_degree", "6",
              "--batch_size", "16", "--neg_sample_size", "4",
              "--learning_rate", "0.01", "--base_log_dir", str(tmp_path),
              "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"]
    assert cli.main(["unsupervised"] + common + [
        "--print_every", "5", "--validate_iter", "5",
        "--validate_batch_size", "8", "--max_total_steps", "12"]) == 0
    out = capsys.readouterr().out
    assert out.count("Iter:") == 3
    log_dir = tmp_path / "unsup-toy" / "graphsage_mean_small_0.010000"
    assert cli.main(["embed"] + common + ["--out_dir",
                                          str(tmp_path / "emb")]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "emb" / "val.npy"),
                                  np.load(log_dir / "val.npy"))


def test_unsupervised_cli_defaults_match_jax():
    """The unsupervised and embed subcommands' defaults are the JAX
    package's, for every flag both take."""
    for argv in (["unsupervised", "--train_prefix", "x"],
                 ["embed", "--train_prefix", "x"]):
        ours = vars(cli.build_parser().parse_args(argv))
        theirs = vars(jcli.build_parser().parse_args(argv))
        shared = (ours.keys() & theirs.keys()) - {"command"}
        assert {"learning_rate", "max_degree", "neg_sample_size",
                "model"} <= shared
        for k in shared:
            assert ours[k] == theirs[k], (argv[0], k)
    assert {"epochs", "print_every", "validate_iter", "random_context",
            "save_embeddings"} <= vars(cli.build_parser().parse_args(
                ["unsupervised", "--train_prefix", "x"])).keys()
    args = cli.build_parser().parse_args(
        ["unsupervised", "--train_prefix", "x", "--no-random_context",
         "--no-save_embeddings", "--neg_sample_size", "7"])
    assert not args.random_context and not args.save_embeddings
    assert args.neg_sample_size == 7


@pytest.mark.parametrize("argv,match", [
    (["--n_model_shards", "2"], "A.9c"),
    (["--graph_shards", "2"], None),
    (["--data_shards", "2"], None),
    (["--coordinator_address", "localhost:1234", "--num_processes", "2",
      "--process_id", "0"], None),
])
def test_unported_options_raise(tmp_path, monkeypatch, argv, match):
    """Every subcommand refuses ``--n_model_shards`` (A.9c), naming its
    ROADMAP.md item, and runs the other multi-device options: shards
    start their ranks (recorded here instead of started: the sharded
    runs are tests/test_torch_sharded_cli.py's and
    tests/test_torch_unsup_sharded_cli.py's), ``predict`` and ``embed``
    run ``--data_shards`` alone on one device as the JAX package does
    (and so ask for their checkpoint), and a multi-host command whose
    ranks do not split over its hosts is refused before anything
    starts."""
    from graphsage_tpu_torch.parallel import launch

    started = []
    monkeypatch.setattr(launch, "spawn", lambda fn, args, devices, *a, **k:
                        started.append((fn, len(devices))))
    g = make_synthetic_graph(num_nodes=40, num_classes=3, feat_dim=8, seed=1)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    rank_fns = {"unsupervised": launch.unsupervised_rank,
                "embed": launch.embed_rank,
                "supervised": launch.supervised_rank,
                "predict": launch.predict_rank}
    for command, rank_fn in rank_fns.items():
        args = [command, "--train_prefix", prefix, "--checkpoint_dir",
                str(tmp_path / "none"), "--device", "cpu"] + argv
        if command == "unsupervised":
            args.append("--no-random_context")
        if match is not None:
            with pytest.raises(NotImplementedError, match=match):
                cli.main(args)
        elif "--num_processes" in argv:
            with pytest.raises(ValueError, match="--num_processes 2"):
                cli.main(args)
        elif command in ("predict", "embed") and "--data_shards" in argv:
            with pytest.raises(FileNotFoundError, match="no checkpoint"):
                cli.main(args)
        else:
            assert cli.main(args) == 0
            assert started.pop() == (rank_fn, 2)
    assert started == []


def test_random_context_needs_walks(tmp_path):
    g = make_synthetic_graph(num_nodes=40, num_classes=3, feat_dim=8, seed=1)
    with pytest.raises(ValueError, match="walk pairs"):
        tun.train(_flags(tmp_path, random_context=True), graph=g,
                  device="cpu")
