"""The port's serving slice: ``predict`` against the JAX package's eval
sweep on the same dataset, adjacency and weights (first_k sampling),
and the device rules of its entry points."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu.models import supervised as js
from graphsage_tpu.train.metrics import calc_f1 as sk_calc_f1
from graphsage_tpu.train.supervised import _run_eval_sweep, make_eval_sweep
from graphsage_tpu_torch import cli, infer
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.models.supervised import init_supervised_params
from graphsage_tpu_torch.train import checkpoint
from graphsage_tpu_torch.train.config import TrainFlags
from tests._torch_common import port_params


def _flags(tmp_path, **kw):
    base = dict(train_prefix=str(tmp_path / "toy" / "toy"), samples_1=4,
                samples_2=3, dim_1=8, dim_2=8, max_degree=8, batch_size=16,
                sampler_mode="first_k", checkpoint_dir=str(tmp_path / "ck"),
                base_log_dir=str(tmp_path), seed=5)
    base.update(kw)
    return TrainFlags(**base)


@pytest.mark.parametrize("sigmoid,nodes,identity_dim,weight_decay", [
    (False, "test", 0, 0.0), (True, "all", 0, 0.01), (False, "all", 4, 0.0),
])
def test_predict_matches_jax_eval_sweep(tmp_path, sigmoid, nodes,
                                        identity_dim, weight_decay):
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             multilabel=sigmoid, seed=11)
    flags = _flags(tmp_path, sigmoid=sigmoid, identity_dim=identity_dim,
                   weight_decay=weight_decay)
    write_dataset(g, flags.train_prefix)

    # the JAX side gets the same loaded table, adjacency and weights
    graph = load_data(flags.train_prefix)
    _, _, adj = build_both_adjs(graph, flags.max_degree, seed=flags.seed)
    tcfg = infer.build_supervised_config(flags, graph)
    s = tcfg.sage
    jcfg = js.SupervisedConfig(
        sage=jg.SAGEConfig(
            layers=tuple(jg.LayerInfo(li.num_samples, li.output_dim)
                         for li in s.layers),
            feature_dim=s.feature_dim, aggregator=s.aggregator,
            concat=s.concat, identity_dim=s.identity_dim,
            num_nodes=s.num_nodes, sampler_mode="first_k",
            fused_gather=True),
        num_classes=tcfg.num_classes, sigmoid_loss=sigmoid,
        weight_decay=weight_decay)
    jparams = js.init_supervised_params(jax.random.key(3), jcfg)
    checkpoint.save(flags.checkpoint_dir, port_params(jparams), 42)

    node_idx = infer._select_nodes(graph, nodes)
    assert len(node_idx) % flags.batch_size  # a dummy-padded last batch
    sweep = make_eval_sweep(jcfg, flags.batch_size, graph.num_nodes)
    jloss, jpreds, jlabels, _ = _run_eval_sweep(
        sweep, jparams, jnp.asarray(graph.padded_features()),
        jnp.asarray(adj), node_idx, graph.labels, flags.batch_size,
        graph.num_nodes, jax.random.key(0))
    jf1 = sk_calc_f1(jlabels, jpreds, sigmoid)

    out = infer.predict(flags, out_dir=str(tmp_path / "out"), nodes=nodes,
                        device="cpu")
    preds = np.load(os.path.join(out["out_dir"], "preds.npy"))
    with open(os.path.join(out["out_dir"], "nodes.txt")) as fp:
        assert fp.read().splitlines() == [graph.node_ids[i]
                                          for i in node_idx]
    assert out["step"] == 42 and out["n"] == len(node_idx)
    np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["loss"], jloss, rtol=1e-5, atol=1e-6)
    assert (out["f1_micro"], out["f1_macro"]) == pytest.approx(jf1,
                                                               abs=1e-12)


def test_cli_predict_writes_outputs(tmp_path):
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=2)
    flags = _flags(tmp_path)
    write_dataset(g, flags.train_prefix)
    cfg = infer.build_supervised_config(flags, load_data(flags.train_prefix))
    checkpoint.save(flags.checkpoint_dir, init_supervised_params(
        torch.Generator().manual_seed(0), cfg), 1)
    out = tmp_path / "cli_out"
    assert cli.main([
        "predict", "--train_prefix", flags.train_prefix, "--checkpoint_dir",
        flags.checkpoint_dir, "--samples_1", "4", "--samples_2", "3",
        "--dim_1", "8", "--dim_2", "8", "--max_degree", "8",
        "--batch_size", "16", "--nodes", "val", "--out_dir", str(out),
        "--device", "cpu", "--seed", "5",
    ]) == 0
    preds = np.load(out / "preds.npy")
    assert preds.shape == (int(g.is_val.sum()), 3)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-5)
    assert len((out / "nodes.txt").read_text().splitlines()) == len(preds)


def test_predict_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def no_load(*a, **k):
        raise AssertionError("nothing may run before the device check")

    monkeypatch.setattr(infer, "load_data", no_load)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.predict(_flags(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_predict_rejects_mismatched_checkpoint(tmp_path):
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=2)
    flags = _flags(tmp_path)
    cfg = infer.build_supervised_config(
        dataclasses.replace(flags, dim_1=16), g)
    checkpoint.save(flags.checkpoint_dir, init_supervised_params(
        torch.Generator(), cfg), 1)
    with pytest.raises(ValueError, match="does not match"):
        infer.predict(flags, graph=g, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        infer.predict(dataclasses.replace(flags, checkpoint_dir=""), graph=g,
                      device="cpu")
    with pytest.raises(FileNotFoundError):
        infer.predict(dataclasses.replace(
            flags, checkpoint_dir=str(tmp_path / "none")), graph=g,
            device="cpu")


def test_unlabeled_dataset_needs_num_classes(tmp_path):
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=2)
    flags = _flags(tmp_path)
    checkpoint.save(flags.checkpoint_dir, init_supervised_params(
        torch.Generator(), infer.build_supervised_config(flags, g)), 1)
    unlabeled = dataclasses.replace(g, labels=None, class_map=None,
                                    num_classes=None)
    with pytest.raises(ValueError, match="num_classes"):
        infer.predict(flags, graph=unlabeled, device="cpu")
    out = infer.predict(flags, out_dir=str(tmp_path / "u"), nodes="all",
                        num_classes=3, graph=unlabeled, device="cpu")
    assert "f1_micro" not in out
    assert np.load(os.path.join(out["out_dir"], "preds.npy")).shape == (60, 3)


def test_cli_predict_dedup_gather_matches_default(tmp_path, monkeypatch):
    """``predict --dedup_gather`` reaches the fused gather-mean (K3's
    plain version on the CPU) and gives the default path's predictions
    from the same checkpoint and samples, up to f32 rounding of the two
    means."""
    from graphsage_tpu_torch.models import graphsage as tg

    dedup_flags = []
    orig = tg.fused_gather_mean

    def recording(*a, **kw):
        dedup_flags.append(kw["dedup"])
        return orig(*a, **kw)

    monkeypatch.setattr(tg, "fused_gather_mean", recording)
    g = make_synthetic_graph(num_nodes=90, num_classes=3, feat_dim=8,
                             seed=6)
    flags = _flags(tmp_path, sampler_mode="shared_perm")
    write_dataset(g, flags.train_prefix)
    cfg = infer.build_supervised_config(flags, load_data(flags.train_prefix))
    checkpoint.save(flags.checkpoint_dir, init_supervised_params(
        torch.Generator().manual_seed(1), cfg), 1)
    argv = ["predict", "--train_prefix", flags.train_prefix,
            "--checkpoint_dir", flags.checkpoint_dir, "--samples_1", "4",
            "--samples_2", "3", "--dim_1", "8", "--dim_2", "8",
            "--max_degree", "8", "--batch_size", "16", "--nodes", "all",
            "--device", "cpu", "--seed", "5"]
    preds = {}
    for extra in ([], ["--dedup_gather"]):
        out = tmp_path / f"out{len(extra)}"
        dedup_flags.clear()
        assert cli.main(argv + ["--out_dir", str(out)] + extra) == 0
        assert dedup_flags and set(dedup_flags) == {bool(extra)}
        preds[len(extra)] = np.load(out / "preds.npy")
    assert preds[0].shape == (90, 3)
    np.testing.assert_allclose(preds[1], preds[0], rtol=1e-5, atol=1e-6)
