"""``python -m graphsage_tpu_torch unsupervised`` and ``embed`` on several
ranks, on the CPU (each command starts its gloo ranks itself; every run
a process group of its own with a 120 s limit,
``tests/_torch_common.py::run_clis``), ``first_k`` sampling, dropout 0
and an identity table:

- ``--data_shards 2`` draws the one-device negatives and is held to the
  one-device command: the final checkpoint's params at the chunk
  runners' tolerances (``assert_params_close``: rtol 2e-4 / atol 1e-6
  where Adam resolves the gradient) and ``val.npy`` at rtol 1e-5 /
  atol 1e-6;
- ``--graph_shards 2`` and the 2 x 2 grid draw each rank's own
  negatives (as the JAX package's), so they are held to what they
  write: the log lines, ``val.npy`` (N rows of unit norm) and
  ``val.txt``, a checkpoint with the identity table whole, and ``embed``
  on the same grid reproducing ``val.npy`` bit for bit; ``embed
  --graph_shards 2`` of one checkpoint within 1e-5 of ``embed`` on one
  device (the split mean sums in another order);
- a ``--graph_shards 2`` checkpoint resumed on one device, under
  ``--shard_layout block`` and on the 2 x 2 grid: saved back bit for
  bit (params, identity table, Adam moments) with ``--epochs 0``, and
  trained on;
- ``--model n2v`` with shard flags trains on one device, as in the JAX
  package: the one-device command's ``val.npy`` and ``val-test.npy``,
  bit for bit, and no rank started.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from graphsage_tpu_torch import cli
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.parallel import launch
from graphsage_tpu_torch.train.checkpoint import latest_step
from tests._torch_common import run_clis
from tests.test_torch_sharded import assert_params_close
from tests.test_torch_sharded_cli import checkpoint

MODEL = ["--batch_size", "16", "--samples_1", "4", "--samples_2", "3",
         "--dim_1", "8", "--dim_2", "8", "--max_degree", "8",
         "--identity_dim", "4", "--sampler_mode", "first_k",
         "--device", "cpu"]
TRAIN = ["--neg_sample_size", "4", "--learning_rate", "0.01",
         "--no-random_context", "--epochs", "1", "--validate_iter", "3",
         "--validate_batch_size", "8", "--print_every", "2",
         "--max_total_steps", "7"]
LOG_DIR = ("unsup-toy", "graphsage_mean_small_0.010000")
GRIDS = {"gs2": ["--graph_shards", "2"], "ds2": ["--data_shards", "2"],
         "grid": ["--graph_shards", "2", "--data_shards", "2"]}


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             seed=7)
    prefix = str(tmp_path_factory.mktemp("data") / "toy" / "toy")
    write_dataset(g, prefix)
    return prefix


def unsupervised_argv(prefix, tmp, extra):
    return (["unsupervised", "--train_prefix", prefix, "--base_log_dir",
             str(tmp / "log"), "--checkpoint_dir", str(tmp / "ck")]
            + MODEL + TRAIN + extra)


def embeddings(tmp):
    log_dir = os.path.join(str(tmp / "log"), *LOG_DIR)
    with open(os.path.join(log_dir, "val.txt")) as fp:
        ids = fp.read().splitlines()
    return np.load(os.path.join(log_dir, "val.npy")), ids


@pytest.fixture(scope="module")
def runs(prefix, tmp_path_factory):
    """The one-device run (in this process) and the three sharded runs
    (started together): name -> (tmp dir, stdout)."""
    out = {}
    tmp = tmp_path_factory.mktemp("one")
    assert cli.main(unsupervised_argv(prefix, tmp, [])) == 0
    out["one"] = (tmp, "")
    tmps = {name: tmp_path_factory.mktemp(name) for name in GRIDS}
    stdouts = run_clis([(unsupervised_argv(prefix, tmps[name], flags), {})
                        for name, flags in GRIDS.items()],
                       tmp_path_factory.mktemp("cli"))
    for name, stdout in zip(GRIDS, stdouts):
        out[name] = (tmps[name], stdout)
    return out


@pytest.mark.parametrize("name", list(GRIDS))
def test_sharded_unsupervised_trains_and_exports(runs, name):
    tmp, out = runs[name]
    assert out.count("Iter:") == 4 and "Optimization Finished!" in out
    assert "WARNING" not in out
    if name != "ds2":
        assert "graph_shards=2 layout=strided capacity_factor=" in out
    rows, ids = embeddings(tmp)
    assert rows.shape == (120, 16) and rows.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-5)
    assert ids == embeddings(runs["one"][0])[1]
    state = checkpoint(tmp / "ck")
    assert state["step"] == 8 and state["opt_state"]["count"] == 8
    # the identity table and its moments whole, in canonical order
    assert state["params"]["embeds"].shape == (121, 4)
    assert state["opt_state"]["nu"]["embeds"].shape == (121, 4)


def test_data_shards_matches_one_device(runs):
    ref, ours = checkpoint(runs["one"][0] / "ck"), checkpoint(
        runs["ds2"][0] / "ck")
    opt = ref["opt_state"]
    root_nu = {k: np.sqrt(v.numpy() / (1 - 0.999 ** opt["count"]))
               for k, v in opt["nu"].items()}
    assert_params_close({k: v.numpy() for k, v in ours["params"].items()},
                        {k: v.numpy() for k, v in ref["params"].items()},
                        root_nu, ref["step"])
    np.testing.assert_allclose(embeddings(runs["ds2"][0])[0],
                               embeddings(runs["one"][0])[0], rtol=1e-5,
                               atol=1e-6)


def test_graph_shards_differ_from_one_device(runs):
    """Each graph rank draws its own negatives: a sharded run trains on
    other negatives than one device (its params differ), as the JAX
    package's does."""
    ref = checkpoint(runs["one"][0] / "ck")["params"]
    ours = checkpoint(runs["gs2"][0] / "ck")["params"]
    assert not torch.equal(ours["aggs.0.neigh_w"], ref["aggs.0.neigh_w"])


@pytest.fixture(scope="module")
def embeds(prefix, runs, tmp_path_factory):
    """``embed`` from the gs2 and grid checkpoints on their own grids,
    and from the one-device checkpoint at --graph_shards 2 and on one
    device: name -> val.npy."""
    tmp = tmp_path_factory.mktemp("embed")
    cases = {"gs2": ("gs2", GRIDS["gs2"]), "grid": ("grid", GRIDS["grid"]),
             "one_gs2": ("one", GRIDS["gs2"])}
    argv = {name: ["embed", "--train_prefix", prefix, "--checkpoint_dir",
                   str(runs[src][0] / "ck"), "--out_dir", str(tmp / name)]
            + MODEL + flags for name, (src, flags) in cases.items()}
    run_clis([(a, {}) for a in argv.values()], tmp)
    assert cli.main(["embed", "--train_prefix", prefix, "--checkpoint_dir",
                     str(runs["one"][0] / "ck"), "--out_dir",
                     str(tmp / "one")] + MODEL) == 0
    return {name: np.load(tmp / name / "val.npy")
            for name in list(cases) + ["one"]}


@pytest.mark.parametrize("name", ["gs2", "grid"])
def test_embed_reproduces_the_sharded_export(runs, embeds, name):
    np.testing.assert_array_equal(embeds[name], embeddings(runs[name][0])[0])


def test_embed_graph_shards_matches_one_device(runs, embeds):
    np.testing.assert_array_equal(embeds["one"],
                                  embeddings(runs["one"][0])[0])
    np.testing.assert_allclose(embeds["one_gs2"], embeds["one"], rtol=1e-5,
                               atol=1e-6)


ELSEWHERE = {"one_device": [], "block": ["--graph_shards", "2",
                                         "--shard_layout", "block"],
             "grid": GRIDS["grid"]}


@pytest.fixture(scope="module")
def resumed(prefix, runs, tmp_path_factory):
    """The gs2 checkpoint resumed elsewhere: for no epoch (it saves what
    it restored), then for two more steps. name -> (checkpoint before,
    after, stdouts)."""
    before = checkpoint(runs["gs2"][0] / "ck")
    tmps = {}
    for name in ELSEWHERE:
        tmps[name] = tmp_path_factory.mktemp(f"resume_{name}")
        shutil.copytree(runs["gs2"][0] / "ck", tmps[name] / "ck")

    def argv(name, extra):
        return ["unsupervised", "--train_prefix", prefix, "--base_log_dir",
                str(tmps[name] / "log"), "--checkpoint_dir",
                str(tmps[name] / "ck"), "--resume",
                "--no-save_embeddings"] + MODEL + TRAIN[:-2] + extra

    outs = run_clis([(argv(name, ["--epochs", "0"] + where), {})
                     for name, where in ELSEWHERE.items()],
                    tmp_path_factory.mktemp("resume_cli"))
    after = {name: checkpoint(tmps[name] / "ck") for name in ELSEWHERE}
    trained = run_clis([(argv(name, ["--max_total_steps",
                                     str(before["step"] + 1)] + where), {})
                        for name, where in ELSEWHERE.items()],
                       tmp_path_factory.mktemp("resume_cli2"))
    steps = {name: latest_step(str(tmps[name] / "ck")) for name in ELSEWHERE}
    return before, after, dict(zip(ELSEWHERE, zip(outs, trained))), steps


@pytest.mark.parametrize("where", list(ELSEWHERE))
def test_resume_restores_the_checkpoint_exactly(resumed, where):
    before, after, outs, steps = resumed
    restored = f"Resumed from checkpoint at step {before['step']}"
    assert restored in outs[where][0] and restored in outs[where][1]
    a = after[where]
    assert a["step"] == before["step"]
    assert a["opt_state"]["count"] == before["opt_state"]["count"]
    for tree in ("params", "mu", "nu"):
        x = a[tree] if tree == "params" else a["opt_state"][tree]
        y = before[tree] if tree == "params" else before["opt_state"][tree]
        assert x.keys() == y.keys()
        for k in y:
            assert torch.equal(x[k], y[k]), (tree, k)
    # and trains on from it
    assert steps[where] == before["step"] + 2
    assert "Optimization Finished!" in outs[where][1]


@pytest.mark.parametrize("shards", [GRIDS["gs2"], GRIDS["ds2"]],
                         ids=["graph_shards", "data_shards"])
def test_node2vec_trains_on_one_device(prefix, tmp_path, monkeypatch,
                                       shards):
    def no_spawn(*args, **kwargs):
        raise AssertionError("ranks started")

    monkeypatch.setattr(launch, "spawn", no_spawn)
    common = ["unsupervised", "--model", "n2v", "--train_prefix", prefix,
              "--dim_1", "8", "--batch_size", "16", "--learning_rate", "2.0",
              "--epochs", "1", "--n2v_test_epochs", "1",
              "--no-random_context", "--device", "cpu"]
    for name, extra in (("one", []), ("sharded", shards)):
        assert cli.main(common + ["--base_log_dir", str(tmp_path / name)]
                        + extra) == 0
    log_dir = ("unsup-toy", "n2v_small_2.000000")
    for out in ("val.npy", "val-test.npy"):
        one = np.load(os.path.join(str(tmp_path / "one"), *log_dir, out))
        sharded = np.load(os.path.join(str(tmp_path / "sharded"), *log_dir,
                                       out))
        assert one.shape == (120, 16)
        np.testing.assert_array_equal(sharded, one)
