"""``--profile_dir`` and ``--log_histograms`` in the port's trainers:
the profile is a Chrome trace of the training loop written into the
directory, the port's spans its ranges, and the histograms are records
in ``histograms.jsonl`` (and TensorBoard's, where it imports) of every
parameter and of the probe batch's per-layer activations, at every
print step; the JAX package's activation names (``acts/input``,
``acts/layer_<L>/hop_<H>``) and shapes."""

import json
import os

import jax
import numpy as np
import torch

from graphsage_tpu.models import graphsage as jg
from graphsage_tpu_torch import cli
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.models import graphsage as tg
from tests._torch_common import port_params, t


def test_supervised_cli_profile_and_histograms(tmp_path):
    g = make_synthetic_graph(num_nodes=80, num_classes=3, feat_dim=8, seed=5)
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(g, prefix)
    profile_dir = str(tmp_path / "prof")
    assert cli.main([
        "supervised", "--train_prefix", prefix, "--samples_1", "3",
        "--samples_2", "2", "--dim_1", "6", "--dim_2", "6", "--max_degree",
        "6", "--batch_size", "16", "--epochs", "1", "--print_every", "2",
        "--validate_iter", "3", "--validate_batch_size", "8",
        "--base_log_dir", str(tmp_path), "--profile_dir", profile_dir,
        "--log_histograms", "--device", "cpu"]) == 0
    traces = os.listdir(profile_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(profile_dir, traces[0])) as fp:
        trace = json.load(fp)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)        # the model's products
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"train.chunk", "train.step", "sample", "gather", "aggregate",
            "head", "backward", "optimizer", "eval.step"} <= ranges
    log_dir = os.path.join(str(tmp_path), "sup-toy",
                           "graphsage_mean_small_0.0100")
    with open(os.path.join(log_dir, "histograms.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    with open(os.path.join(log_dir, "metrics.jsonl")) as fp:
        print_steps = {json.loads(line)["step"] for line in fp
                       if "train_loss" in line}
    assert {r["step"] for r in recs} == print_steps
    names = {r["name"] for r in recs}
    assert {"params/aggs.0.neigh_w", "params/head.w", "acts/input",
            "acts/layer_0/hop_0", "acts/layer_0/hop_1",
            "acts/layer_1/hop_0"} <= names
    for r in recs:
        assert sum(r["counts"]) > 0 and r["min"] <= r["mean"] <= r["max"]


def test_capture_matches_jax_activations():
    """sage_embed's capture: the JAX package's names, shapes and values
    (first_k sampling, the same weights)."""
    g = make_synthetic_graph(num_nodes=60, num_classes=3, feat_dim=8, seed=2)
    _, _, adj = build_both_adjs(g, 6, seed=1)
    jcfg = jg.SAGEConfig(layers=(jg.LayerInfo(3, 6), jg.LayerInfo(2, 6)),
                         feature_dim=8, num_nodes=g.num_nodes,
                         sampler_mode="first_k")
    tcfg = tg.SAGEConfig(layers=(tg.LayerInfo(3, 6), tg.LayerInfo(2, 6)),
                         feature_dim=8, num_nodes=g.num_nodes,
                         sampler_mode="first_k")
    jparams = jg.init_sage_params(jax.random.key(0), jcfg)
    ids = np.arange(10, dtype=np.int32)
    feats = g.padded_features()
    jcap = jax.device_get(jg.make_activations_fn(jcfg)(
        jparams, jax.numpy.asarray(feats), jax.numpy.asarray(adj),
        jax.numpy.asarray(ids), jax.random.key(1)))
    cap = {}
    tg.sage_embed(port_params(jparams), t(feats), t(adj), t(ids), tcfg,
                  deterministic=True, capture=cap)
    assert set(cap) == set(jcap)
    for k in cap:
        np.testing.assert_allclose(cap[k].detach().numpy(), jcap[k],
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert isinstance(cap["acts/input"], torch.Tensor)
