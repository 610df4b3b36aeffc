"""The port's node2vec trainer (``train/unsupervised.py::_train_n2v``) on
the CPU, the counterpart of the JAX package's
``tests/test_train.py::test_n2v_end_to_end``: ``val.npy``/``val.txt``
and ``val-test.npy``/``val-test.txt`` of the target table in id order,
the retrain moving the eval nodes' rows and no other (frozen rows
bit-identical), the same run twice bit for bit, and the
``unsupervised --model n2v`` and ``eval`` subcommands."""

import json
import os

import numpy as np
import pytest
import torch

from graphsage_tpu.train.config import TrainFlags as JaxTrainFlags
from graphsage_tpu_torch import cli
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.train import unsupervised as tun
from graphsage_tpu_torch.train.config import TrainFlags


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_graph(num_nodes=120, num_classes=3, feat_dim=8,
                                seed=6)


def _flags(tmp_path, **kw):
    base = dict(train_prefix=str(tmp_path / "toy" / "toy"), model="n2v",
                dim_1=4, batch_size=16, neg_sample_size=5,
                learning_rate=0.5, epochs=2, print_every=3,
                random_context=False, base_log_dir=str(tmp_path), seed=4)
    base.update(kw)
    return TrainFlags(**base)


def _read(log_dir, mod=""):
    rows = np.load(os.path.join(log_dir, f"val{mod}.npy"))
    with open(os.path.join(log_dir, f"val{mod}.txt")) as fp:
        return rows, fp.read().splitlines()


def test_n2v_trainer_and_retrain(tmp_path, graph):
    plain = tun.train(_flags(tmp_path / "a", save_embeddings=False),
                      graph=graph, device="cpu")
    out = tun.train(_flags(tmp_path / "b", save_embeddings=True,
                           n2v_test_epochs=2), graph=graph, device="cpu")
    n = graph.num_nodes
    rows, ids = _read(out["log_dir"])
    test_rows, test_ids = _read(out["log_dir"], "-test")
    assert rows.shape == test_rows.shape == (n, 8)
    assert ids == test_ids == [str(i) for i in graph.node_ids]
    assert out["steps"] == plain["steps"] > 0
    before = {k: v.detach() for k, v in plain["params"].items()}
    after = {k: v.detach() for k, v in out["params"].items()}
    # val.npy: the target table as the main phase left it
    np.testing.assert_array_equal(rows, before["target"][:n].numpy())
    np.testing.assert_array_equal(test_rows, after["target"][:n].numpy())
    evalnodes = graph.is_val | graph.is_test
    frozen = np.append(~evalnodes, True)          # and the dummy row
    torch.testing.assert_close(after["context"][frozen],
                               before["context"][frozen], rtol=0, atol=0)
    torch.testing.assert_close(after["target"][frozen],
                               before["target"][frozen], rtol=0, atol=0)
    moved = (after["target"][:n][evalnodes]
             != before["target"][:n][evalnodes]).any(dim=1)
    assert moved.float().mean() > 0.5
    # the freeze holds the context embeddings only, as in both packages
    # (the reference's stop_gradient): the context bias keeps training
    assert (after["bias"] != before["bias"]).any()
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as fp:
        recs = [json.loads(line) for line in fp]
    assert recs and all(np.isfinite(r["train_loss"])
                        and 0 < r["train_mrr"] <= 1 for r in recs)


def test_n2v_runs_are_reproducible_and_stop(tmp_path, graph):
    a = tun.train(_flags(tmp_path / "a", max_total_steps=4,
                         save_embeddings=False), graph=graph, device="cpu")
    b = tun.train(_flags(tmp_path / "b", max_total_steps=4,
                         save_embeddings=False), graph=graph, device="cpu")
    assert a["steps"] == b["steps"] == 5
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k], rtol=0,
                                   atol=0)


def test_flags_match_the_jax_package():
    ours, theirs = TrainFlags(), JaxTrainFlags()
    for name in ("n2v_test_epochs", "defer_features", "degree_relabel",
                 "profile_dir", "log_histograms", "n_model_shards"):
        assert getattr(ours, name) == getattr(theirs, name), name


def test_cli_unsupervised_n2v_then_eval(tmp_path, graph, capsys):
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(graph, prefix)
    assert cli.main([
        "unsupervised", "--train_prefix", prefix, "--model", "n2v",
        "--dim_1", "4", "--batch_size", "16", "--neg_sample_size", "5",
        "--learning_rate", "0.5", "--epochs", "2", "--print_every", "4",
        "--no-random_context", "--save_embeddings", "--n2v_test_epochs",
        "2", "--base_log_dir", str(tmp_path), "--device", "cpu"]) == 0
    log_dir = os.path.join(str(tmp_path), "unsup-toy", "n2v_small_0.500000")
    for name in ("val.npy", "val.txt", "val-test.npy", "val-test.txt"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    out = capsys.readouterr().out
    assert "train_mrr=" in out and "Optimization Finished!" in out
    assert cli.main(["eval", prefix, log_dir, "test", "--sgd_max_iter", "5",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    f1 = float(out.split("test F1 (micro):")[1].split()[0])
    assert 0.0 <= f1 <= 1.0
    assert "dummy baseline F1 (micro):" in out
