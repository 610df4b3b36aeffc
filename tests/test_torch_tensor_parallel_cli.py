"""``python -m graphsage_tpu_torch supervised --n_model_shards`` on gloo
ranks on the CPU (feature-dim tensor parallelism, ``parallel/tensor.py``),
held to the one-device command from the same seed: at 1 x 2 and 2 x 2
(data x model) with ``first_k`` sampling, dropout 0 and an identity
table, and at 1 x 2 with dropout 0.5 and the default sampler (one data
slice draws as one device does). Every printed ``Iter:`` line's train
and val losses within 2e-5 (their printed precision, 1e-5, and the
rounding of the partial products' other summation order), the
``val_stats.txt``/``test_stats.txt`` losses likewise; the checkpoint
whole, its params held as ``test_torch_tensor_parallel.py`` holds the
first step's (rtol 2e-4 where Adam resolves the gradient, 5% of lr a
step elsewhere). A tensor-parallel checkpoint loads in one-device
``predict`` (within 1e-5 of the one-device checkpoint's predictions),
and ``--resume`` under tensor parallelism saves back what it restored,
bit for bit. ``--graph_shards`` with ``--n_model_shards`` is refused
with the JAX package's ValueError before any rank starts;
``unsupervised``, ``embed`` and ``predict`` ignore the flag, as the
JAX package's do: their outputs equal those of the runs without it, bit
for bit. Each batch of processes has a 120 s limit
(``tests/_torch_common.py::run_clis``).
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
from tests._torch_common import run_clis
from tests.test_torch_sharded_cli import (
    LOG_DIR,
    MODEL,
    TRAIN,
    checkpoint,
    stats_losses,
)

SAME = ["--identity_dim", "8", "--sampler_mode", "first_k"]
RUNS = {
    # name: flags
    "one": SAME,
    "tp2": SAME + ["--n_model_shards", "2"],
    "tp2x2": SAME + ["--n_model_shards", "2", "--data_shards", "2"],
    "one_drop": ["--identity_dim", "8", "--dropout", "0.5"],
    "tp2_drop": ["--identity_dim", "8", "--dropout", "0.5",
                 "--n_model_shards", "2"],
}
HELD = {"tp2": "one", "tp2x2": "one", "tp2_drop": "one_drop"}


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=10,
                             seed=7)
    prefix = str(tmp_path_factory.mktemp("data") / "toy" / "toy")
    write_dataset(g, prefix)
    return prefix


def supervised_argv(prefix, tmp, flags):
    return (["supervised", "--train_prefix", prefix, "--base_log_dir",
             str(tmp / "log"), "--checkpoint_dir", str(tmp / "ck")]
            + MODEL + TRAIN + flags)


@pytest.fixture(scope="module")
def runs(prefix, tmp_path_factory):
    """Every run of ``RUNS``, started together: name -> (tmp dir,
    stdout)."""
    tmps = {name: tmp_path_factory.mktemp(name) for name in RUNS}
    outs = run_clis([(supervised_argv(prefix, tmps[name], flags), {})
                     for name, flags in RUNS.items()],
                    tmp_path_factory.mktemp("cli"))
    return {name: (tmps[name], out) for name, out in zip(RUNS, outs)}


def iter_losses(stdout) -> list:
    """(train_loss, val_loss) of every ``Iter:`` line."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("Iter:"):
            words = line.split()
            out.append((float(words[words.index("train_loss=") + 1]),
                        float(words[words.index("val_loss=") + 1])))
    return out


@pytest.mark.parametrize("name", list(HELD))
def test_tensor_parallel_command_matches_one_device(runs, name):
    (tmp, out), (ref_tmp, ref_out) = runs[name], runs[HELD[name]]
    assert "n_model_shards=2" in out and "Optimization Finished!" in out
    ours, theirs = iter_losses(out), iter_losses(ref_out)
    assert len(ours) == len(theirs) >= 2
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-5)
    np.testing.assert_allclose(stats_losses(tmp / "log"),
                               stats_losses(ref_tmp / "log"), rtol=0,
                               atol=2e-5)
    state, ref = checkpoint(tmp / "ck"), checkpoint(ref_tmp / "ck")
    assert state["step"] == ref["step"]
    opt = ref["opt_state"]
    assert state["opt_state"]["count"] == opt["count"]
    lr, steps = 0.01, ref["step"]
    for k, want in ref["params"].items():
        got = state["params"][k]
        assert got.shape == want.shape, k    # whole, as one device's
        assert state["opt_state"]["nu"][k].shape == want.shape, k
        resolved = (opt["nu"][k] / (1 - 0.999 ** opt["count"])).sqrt() >= 1e-5
        np.testing.assert_allclose(got[resolved].numpy(),
                                   want[resolved].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[~resolved].numpy(),
                                   want[~resolved].numpy(), rtol=0,
                                   atol=0.05 * lr * steps, err_msg=k)


def test_checkpoint_loads_in_one_device_predict(prefix, runs, tmp_path):
    """The 1 x 2 run's checkpoint in ``predict`` on one device, with and
    without the flag (ignored: the same predictions), against the
    one-device run's checkpoint."""
    common = ["--train_prefix", prefix, "--nodes", "all"] + MODEL + SAME
    preds = {}
    for name, ck, extra in (("tp", "tp2", []),
                            ("tp_flag", "tp2", ["--n_model_shards", "2"]),
                            ("one", "one", [])):
        out = tmp_path / name
        assert cli.main(["predict", "--checkpoint_dir",
                         str(runs[ck][0] / "ck"), "--out_dir", str(out)]
                        + common + extra) == 0
        preds[name] = np.load(out / "preds.npy")
    assert preds["tp"].shape == (120, 4)
    np.testing.assert_array_equal(preds["tp_flag"], preds["tp"])
    np.testing.assert_allclose(preds["tp"], preds["one"], rtol=1e-5,
                               atol=1e-6)


def test_resume_under_tensor_parallelism_is_exact(prefix, runs, tmp_path):
    """Resumed for no epoch at 1 x 2, a run saves what it restored: the
    whole params and Adam moments, cut into shards and gathered back,
    bit for bit."""
    ck = shutil.copytree(runs["tp2"][0] / "ck", tmp_path / "ck")
    before = checkpoint(ck)
    out, = run_clis([(["supervised", "--train_prefix", prefix,
                       "--base_log_dir", str(tmp_path / "log"),
                       "--checkpoint_dir", str(ck), "--resume", "--epochs",
                       "0", "--n_model_shards", "2"] + MODEL + SAME, {})],
                    tmp_path)
    assert f"Resumed from checkpoint at step {before['step']}" in out
    after = checkpoint(ck)
    assert after["step"] == before["step"]
    assert after["opt_state"]["count"] == before["opt_state"]["count"]
    for tree in ("params", "mu", "nu"):
        a = after[tree] if tree == "params" else after["opt_state"][tree]
        b = before[tree] if tree == "params" else before["opt_state"][tree]
        assert a.keys() == b.keys()
        for k in b:
            assert torch.equal(a[k], b[k]), (tree, k)


def test_graph_shards_with_model_shards_is_refused(prefix, tmp_path,
                                                   monkeypatch):
    """JAX's trainer refuses the combination with a ValueError
    (``graphsage_tpu/train/supervised.py:147-155``); here no rank is
    started either, nor any log written. ``--n_model_shards`` below 1 is
    refused too."""
    def no_spawn(*args, **kwargs):
        raise AssertionError("ranks started")

    monkeypatch.setattr(launch, "spawn", no_spawn)
    argv = ["supervised", "--train_prefix", prefix, "--base_log_dir",
            str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="does not compose with "
                       "--graph_shards"):
        cli.main(argv + ["--graph_shards", "2", "--n_model_shards", "2"])
    with pytest.raises(ValueError, match="must be >= 1"):
        cli.main(argv + ["--n_model_shards", "0"])
    assert not (tmp_path / LOG_DIR[0]).exists()


def test_supervised_tp_counts_its_ranks(prefix, tmp_path, monkeypatch):
    """``--n_model_shards 2 --data_shards 2`` starts four ranks of
    ``supervised_rank``; a host with one card is refused, naming the
    four devices the grid needs."""
    started = []
    monkeypatch.setattr(launch, "spawn", lambda fn, args, devices, *a, **k:
                        started.append((fn, len(devices))))
    argv = ["supervised", "--train_prefix", prefix, "--base_log_dir",
            str(tmp_path), "--n_model_shards", "2", "--data_shards", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert started == [(launch.supervised_rank, 4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--n_model_shards 2 needs 4 "
                       "CUDA devices"):
        cli.main(argv + ["--device", "cuda"])


UNSUP = ["--batch_size", "16", "--samples_1", "4", "--samples_2", "3",
         "--dim_1", "8", "--dim_2", "8", "--max_degree", "8",
         "--identity_dim", "4", "--device", "cpu"]


def test_unsupervised_and_embed_ignore_the_flag(prefix, tmp_path):
    """``unsupervised`` and ``embed`` with ``--n_model_shards 2`` run on
    one device, as the JAX package's: ``val.npy`` and the embedding
    export equal the runs without the flag, bit for bit."""
    log_dir = ("unsup-toy", "graphsage_mean_small_0.010000")
    out = {}
    for name, extra in (("plain", []), ("flag", ["--n_model_shards", "2"])):
        tmp = tmp_path / name
        assert cli.main(
            ["unsupervised", "--train_prefix", prefix, "--base_log_dir",
             str(tmp / "log"), "--checkpoint_dir", str(tmp / "ck"),
             "--learning_rate", "0.01", "--no-random_context",
             "--neg_sample_size", "4", "--max_total_steps", "3",
             "--validate_iter", "2", "--validate_batch_size", "8"]
            + UNSUP + extra) == 0
        assert cli.main(["embed", "--train_prefix", prefix,
                         "--checkpoint_dir", str(tmp / "ck"), "--out_dir",
                         str(tmp / "embed")] + UNSUP + extra) == 0
        out[name] = (np.load(os.path.join(str(tmp / "log"), *log_dir,
                                          "val.npy")),
                     np.load(tmp / "embed" / "val.npy"))
    for a, b in zip(out["plain"], out["flag"]):
        assert a.shape == (120, 16)
        np.testing.assert_array_equal(a, b)
