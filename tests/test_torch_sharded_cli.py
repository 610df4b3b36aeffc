"""``python -m graphsage_tpu_torch`` on several ranks, on the CPU:
``supervised`` with ``--graph_shards 2``, ``--data_shards 2`` and the
2 x 2 grid, each held to the single-device command from the same seed
(``first_k`` sampling, dropout 0, an identity table): the final
checkpoint's params at the chunk runners' tolerances
(``test_torch_sharded.py``: rtol 2e-4 / atol 1e-6 where Adam resolves
the gradient) and the ``val_stats.txt``/``test_stats.txt`` losses to
their printed precision (1.5e-5); a checkpoint written at D = 2 resumed
on one device and under ``--shard_layout block``, where the restored
params and Adam moments are saved back bit for bit; and ``predict
--graph_shards 2`` against single-device ``predict`` (1e-5: the sweeps
sample alike, the split mean sums in another order). Each run is a
process group of its own with a 120 s limit
(``tests/_torch_common.py::run_cli``); the command starts its gloo
ranks itself. Also ``--validate_batch_size`` below 1 under
``--graph_shards``, which validates on one sampled row as the JAX
package's sharded trainer does; what is still refused, what the
sharded unsupervised commands do in place of their former refusal, and
that a CUDA run never falls back to the CPU.
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
from tests._torch_common import run_cli, run_clis
from tests.test_torch_sharded import assert_params_close

MODEL = ["--batch_size", "16", "--samples_1", "4", "--samples_2", "3",
         "--dim_1", "8", "--dim_2", "8", "--max_degree", "8",
         "--device", "cpu"]
TRAIN = ["--epochs", "1", "--validate_iter", "3", "--validate_batch_size",
         "8", "--print_every", "2"]
LOG_DIR = ("sup-toy", "graphsage_mean_small_0.0100")
# the runs held to one device: nothing random is drawn
SAME = ["--identity_dim", "4", "--sampler_mode", "first_k"]


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    g = make_synthetic_graph(num_nodes=120, num_classes=4, feat_dim=8,
                             seed=7)
    prefix = str(tmp_path_factory.mktemp("data") / "toy" / "toy")
    write_dataset(g, prefix)
    return prefix


def supervised(prefix, base, extra, tmp):
    out = run_cli(["supervised", "--train_prefix", prefix,
                   "--base_log_dir", str(base)] + MODEL + TRAIN + extra, tmp)
    log_dir = os.path.join(str(base), *LOG_DIR)
    for name in ("val_stats.txt", "test_stats.txt", "metrics.jsonl"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    with open(os.path.join(log_dir, "val_stats.txt")) as fp:
        assert fp.read().startswith("loss=")
    return out


def checkpoint(ck) -> dict:
    files = os.listdir(ck)
    assert len(files) == 1
    return torch.load(os.path.join(ck, files[0]), weights_only=True)


def stats_losses(base) -> list:
    log_dir = os.path.join(str(base), *LOG_DIR)
    out = []
    for name in ("val_stats.txt", "test_stats.txt"):
        with open(os.path.join(log_dir, name)) as fp:
            out.append(float(fp.read().split()[0][len("loss="):]))
    return out


@pytest.fixture(scope="module")
def one_device_run(prefix, tmp_path_factory):
    """``supervised`` on one device, ``SAME`` flags, with a checkpoint:
    (checkpoint dir, log base)."""
    tmp = tmp_path_factory.mktemp("one")
    ck = str(tmp / "ck")
    assert cli.main(["supervised", "--train_prefix", prefix,
                     "--base_log_dir", str(tmp / "log"), "--checkpoint_dir",
                     ck] + MODEL + TRAIN + SAME) == 0
    return ck, tmp / "log"


def assert_same_run(ck, base, one_device_run):
    """A sharded run's checkpoint and stats against one device's."""
    ref_ck, ref_base = one_device_run
    ours, ref = checkpoint(ck), checkpoint(ref_ck)
    assert ours["step"] == ref["step"]
    opt = ref["opt_state"]
    root_nu = {k: np.sqrt(v.numpy() / (1 - 0.999 ** opt["count"]))
               for k, v in opt["nu"].items()}
    assert_params_close({k: v.numpy() for k, v in ours["params"].items()},
                        {k: v.numpy() for k, v in ref["params"].items()},
                        root_nu, ref["step"])
    np.testing.assert_allclose(stats_losses(base), stats_losses(ref_base),
                               rtol=0, atol=1.5e-5)


@pytest.fixture(scope="module")
def sharded_run(prefix, tmp_path_factory):
    """``supervised --graph_shards 2``, ``SAME`` flags, with a
    checkpoint: (checkpoint dir, stdout, log base)."""
    tmp = tmp_path_factory.mktemp("gs2")
    ck = str(tmp / "ck")
    out = supervised(prefix, tmp / "log", ["--graph_shards", "2",
                                           "--checkpoint_dir", ck] + SAME,
                     tmp)
    return ck, out, tmp / "log"


def test_graph_shards_trains(sharded_run, one_device_run):
    ck, out, base = sharded_run
    assert "graph_shards=2 layout=strided capacity_factor=" in out
    assert out.count("Iter:") >= 2 and "Optimization Finished!" in out
    assert "WARNING" not in out
    state = checkpoint(ck)
    # the identity table and its moments whole, in canonical order
    assert state["params"]["embeds"].shape == (121, 4)
    assert state["opt_state"]["nu"]["embeds"].shape == (121, 4)
    assert_same_run(ck, base, one_device_run)


@pytest.mark.parametrize("grid", [["--data_shards", "2"],
                                  ["--data_shards", "2", "--graph_shards",
                                   "2"]], ids=["data2", "data2xgraph2"])
def test_data_shards_and_the_grid_train(prefix, tmp_path, grid,
                                        one_device_run):
    ck = str(tmp_path / "ck")
    out = supervised(prefix, tmp_path / "log",
                     grid + SAME + ["--checkpoint_dir", ck], tmp_path)
    assert out.count("Iter:") >= 2 and "Optimization Finished!" in out
    assert_same_run(ck, tmp_path / "log", one_device_run)


def test_overflow_is_counted_and_warned(prefix, tmp_path):
    """A capacity below the balanced share drops the inner hop's requests
    (64,000 a rank at batch 512 and fanouts 10 x 25): the trainer warns
    as the JAX package's does, with the count."""
    out = supervised(prefix, tmp_path / "log",
                     ["--graph_shards", "2", "--capacity_factor", "0.5",
                      "--batch_size", "512", "--samples_1", "25",
                      "--samples_2", "10", "--max_degree", "25",
                      "--max_total_steps", "0"],
                     tmp_path)
    warned = [line for line in out.splitlines()
              if line.startswith("WARNING: train chunks: ")]
    assert warned and "overflowed the all-to-all capacity" in warned[0]
    assert int(warned[0].split()[3]) > 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("start", ["hosts", "torchrun"])
def test_ranks_of_other_processes_join(prefix, tmp_path, start):
    """Two commands, one rank each, make one ``--graph_shards 2`` run:
    as two hosts (``--coordinator_address``, a TCP store at rank 0) or as
    torchrun's processes (the ``env://`` variables)."""
    port = free_port()
    runs = []
    for rank in range(2):
        argv = ["supervised", "--train_prefix", prefix, "--base_log_dir",
                str(tmp_path / "log"), "--graph_shards", "2"] + MODEL + TRAIN
        if start == "hosts":
            runs.append((argv + [
                "--coordinator_address", f"localhost:{port}",
                "--num_processes", "2", "--process_id", str(rank)], {}))
        else:
            runs.append((argv, {
                "WORLD_SIZE": "2", "RANK": str(rank),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2",
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}))
    outs = run_clis(runs, tmp_path)
    assert "graph_shards=2 layout=strided" in outs[0]
    assert "Optimization Finished!" in outs[0] and outs[1] == ""
    log_dir = os.path.join(str(tmp_path / "log"), *LOG_DIR)
    assert os.path.exists(os.path.join(log_dir, "test_stats.txt"))


ELSEWHERE = pytest.mark.parametrize(
    "where", [[], ["--graph_shards", "2", "--shard_layout", "block"]],
    ids=["one_device", "block"])


@ELSEWHERE
def test_checkpoint_resumes_elsewhere(prefix, sharded_run, tmp_path, where):
    ck = shutil.copytree(sharded_run[0], tmp_path / "ck")
    step = int(os.listdir(ck)[0][len("step_"):-len(".pt")])
    out = supervised(prefix, tmp_path / "log",
                     ["--identity_dim", "4", "--checkpoint_dir", str(ck),
                      "--resume", "--max_total_steps", str(step + 2)] + where,
                     tmp_path)
    assert f"Resumed from checkpoint at step {step}" in out


@ELSEWHERE
def test_resume_restores_the_checkpoint_exactly(prefix, sharded_run,
                                                tmp_path, where):
    """Resumed for no epoch, a run saves what it restored: the D = 2
    strided checkpoint's params, identity table and Adam moments come
    back bit for bit through one device's or the block layout's shards."""
    ck = shutil.copytree(sharded_run[0], tmp_path / "ck")
    before = checkpoint(ck)
    out = supervised(prefix, tmp_path / "log",
                     ["--identity_dim", "4", "--checkpoint_dir", str(ck),
                      "--resume", "--epochs", "0"] + where, tmp_path)
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


def test_predict_graph_shards_matches_one_device(prefix, sharded_run,
                                                 tmp_path):
    ck = sharded_run[0]
    common = ["--train_prefix", prefix, "--checkpoint_dir", ck,
              "--identity_dim", "4", "--nodes", "all"] + MODEL
    run_cli(["predict", "--graph_shards", "2", "--out_dir",
             str(tmp_path / "sh")] + common, tmp_path)
    assert cli.main(["predict", "--out_dir", str(tmp_path / "one")]
                    + common) == 0
    sh = np.load(tmp_path / "sh" / "preds.npy")
    one = np.load(tmp_path / "one" / "preds.npy")
    assert sh.shape == one.shape == (120, 4)
    np.testing.assert_allclose(sh, one, rtol=1e-5, atol=1e-6)
    assert ((tmp_path / "sh" / "nodes.txt").read_text()
            == (tmp_path / "one" / "nodes.txt").read_text())


def test_validate_batch_size_below_one_samples_one_row(prefix, tmp_path):
    """``--graph_shards 2`` with ``--validate_batch_size`` 0 or -2
    validates on max(v, 1) = 1 sampled row, as the JAX package's sharded
    trainer (``graphsage_tpu/train/supervised.py:737-739``): its printed
    lines are those of ``--validate_batch_size 1``."""
    runs = [(["supervised", "--train_prefix", prefix, "--base_log_dir",
              str(tmp_path / f"log{v}"), "--graph_shards", "2"] + MODEL
             + ["--epochs", "1", "--validate_iter", "3", "--print_every",
                "2", "--max_total_steps", "5", "--validate_batch_size", v],
             {}) for v in ("0", "-2", "1")]
    outs = run_clis(runs, tmp_path)
    lines = [[line.rsplit(" time=", 1)[0] for line in out.splitlines()
              if line.startswith("Iter:")] for out in outs]
    assert len(lines[2]) == 3 and "val_f1_mic=" in lines[2][0]
    assert lines[0] == lines[2] and lines[1] == lines[2]


@pytest.mark.parametrize("command,argv,match", [
    ("unsupervised", ["--graph_shards", "2"], None),
    ("embed", ["--data_shards", "2"], None),
    ("supervised", ["--n_model_shards", "2"], "A.9c"),
    ("predict", ["--n_model_shards", "2", "--graph_shards", "2"], "A.9c"),
])
def test_still_refused(prefix, tmp_path, monkeypatch, command, argv, match):
    """``--n_model_shards`` is still refused (A.9c). The sharded
    unsupervised commands no longer are: ``unsupervised --graph_shards
    2`` starts its two ranks (recorded here instead of started; the runs
    are tests/test_torch_unsup_sharded_cli.py's), and ``embed
    --data_shards 2`` runs on one device, as the JAX package's, and so
    asks for its checkpoint."""
    started = []
    monkeypatch.setattr(launch, "spawn", lambda fn, args, devices, *a, **k:
                        started.append((fn, len(devices))))
    argv = [command, "--train_prefix", prefix, "--checkpoint_dir",
            str(tmp_path / "ck"), "--device", "cpu"] + argv
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            cli.main(argv)
    elif command == "unsupervised":
        assert cli.main(argv + ["--no-random_context"]) == 0
        assert started == [(launch.unsupervised_rank, 2)]
    else:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            cli.main(argv)
    if command != "unsupervised":
        assert started == []


def test_cuda_without_a_card_never_runs_on_the_cpu(prefix, tmp_path,
                                                   monkeypatch):
    def no_spawn(*args, **kwargs):
        raise AssertionError("ranks started")

    monkeypatch.setattr(launch, "spawn", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["supervised", "--train_prefix", prefix, "--base_log_dir",
                  str(tmp_path), "--graph_shards", "2", "--device", "cuda"])
    # a host with one card is refused, naming the two devices needed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.main(["supervised", "--train_prefix", prefix, "--base_log_dir",
                  str(tmp_path), "--graph_shards", "2", "--device", "cuda"])
    assert not (tmp_path / LOG_DIR[0]).exists()
