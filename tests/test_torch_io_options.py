"""``--degree_relabel`` and ``--defer_features`` in the port
(``data/io.py``) against the JAX package's ``data/io.py``, and both
trainers with them.

Tolerances: relabelled arrays exact; the deferred table's statistics
and rows 1e-6 (float64 sums in both packages, float32 rows); a run on
a deferred table within 1e-6 of the run on the table loaded up front
(the two standardizations round the last bit apart, in both packages);
a relabelled run's exports map to the same original ids.
"""

import os

import numpy as np
import pytest
import torch

from graphsage_tpu.data import io as jio
from graphsage_tpu_torch.data import io as tio
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)
from graphsage_tpu_torch.data.walks import run_random_walks, write_walks
from graphsage_tpu_torch.train import supervised as tsup
from graphsage_tpu_torch.train import unsupervised as tun
from graphsage_tpu_torch.train.config import TrainFlags

TOY_PPI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example_data", "toy-ppi")
ARRAYS = ("features", "labels", "is_val", "is_test", "edges",
          "train_removed", "walks", "feat_rows")


@pytest.fixture(scope="module")
def prefix(tmp_path_factory):
    """A synthetic dataset with a walks file, its feature rows stored in
    another order than the node ids (the id map permutes them)."""
    g = make_synthetic_graph(num_nodes=90, num_classes=3, feat_dim=6, seed=8)
    p = str(tmp_path_factory.mktemp("io") / "toy" / "toy")
    write_dataset(g, p)
    is_train = g.is_train
    pairs = run_random_walks(
        [nb[is_train[nb]] if is_train[i] else nb[:0]
         for i, nb in enumerate(g.neighbors)], np.flatnonzero(is_train), 2,
        3, np.random.default_rng(0))
    write_walks(p + "-walks.txt", pairs, g.node_ids)
    return p


def _assert_same(ours, theirs):
    assert ours.node_ids == theirs.node_ids
    assert ours.id2idx == theirs.id2idx
    assert ours.feature_meta == theirs.feature_meta
    assert ours.feature_dim == theirs.feature_dim
    assert ours.feature_normalize == theirs.feature_normalize
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(ours.neighbors, theirs.neighbors):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("load_features", [True, False])
@pytest.mark.parametrize("source", ["synthetic", "toy-ppi"])
def test_relabel_by_degree_matches_jax(prefix, source, load_features):
    path = prefix if source == "synthetic" else TOY_PPI
    kw = dict(load_walks=True, load_features=load_features,
              degree_relabel=True)
    ours, theirs = tio.load_data(path, **kw), jio.load_data(path, **kw)
    _assert_same(ours, theirs)
    deg = [len(nb) for nb in ours.neighbors]
    assert deg == sorted(deg, reverse=True)
    plain = tio.load_data(path, load_walks=True)
    assert sorted(ours.node_ids) == sorted(plain.node_ids)
    _assert_same(tio.relabel_by_degree(plain),
                 jio.relabel_by_degree(jio.load_data(path, load_walks=True)))


@pytest.mark.parametrize("normalize", [True, False])
def test_deferred_features_match_jax(prefix, normalize):
    ours = tio.load_data(prefix, normalize=normalize, load_features=False,
                         degree_relabel=True)
    theirs = jio.load_data(prefix, normalize=normalize, load_features=False,
                           degree_relabel=True)
    assert ours.features is None and ours.feature_dim == 6
    for a, b in zip(tio.feature_stats(ours, chunk=7),
                    jio.feature_stats(theirs, chunk=7)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    ids = np.array([5, 0, 89, 90, 17, 90])       # 90: the dummy
    rows = tio.load_feature_rows(ours, ids, chunk=4)
    np.testing.assert_allclose(rows, jio.load_feature_rows(theirs, ids,
                                                           chunk=4),
                               rtol=1e-6, atol=1e-6)
    assert (rows[[3, 5]] == 0).all()
    np.testing.assert_allclose(tio.load_feature_shard(ours, 80, 91),
                               jio.load_feature_shard(theirs, 80, 91),
                               rtol=1e-6, atol=1e-6)
    full = tio.materialize_features(ours)
    assert ours.features is None            # the caller's stays deferred
    np.testing.assert_allclose(full.features,
                               jio.materialize_features(theirs).features,
                               rtol=1e-6, atol=1e-6)
    eager = tio.load_data(prefix, normalize=normalize, degree_relabel=True)
    np.testing.assert_allclose(full.features, eager.features, rtol=1e-6,
                               atol=1e-6)
    assert tio.materialize_features(eager) is eager
    with pytest.raises(ValueError, match="deferred"):
        tio.load_feature_rows(eager, ids)


def _sup_flags(prefix, tmp_path, **kw):
    return TrainFlags(train_prefix=prefix, samples_1=3, samples_2=2,
                      dim_1=6, dim_2=6, max_degree=6, batch_size=16,
                      epochs=1, print_every=2, validate_iter=3,
                      validate_batch_size=8, sampler_mode="first_k",
                      base_log_dir=str(tmp_path), **kw)


def test_supervised_trainer_with_both_flags(prefix, tmp_path):
    base = tsup.train(_sup_flags(prefix, tmp_path / "a",
                                 degree_relabel=True), device="cpu")
    deferred = tsup.train(_sup_flags(prefix, tmp_path / "b",
                                     degree_relabel=True,
                                     defer_features=True), device="cpu")
    for k in base["params"]:
        torch.testing.assert_close(deferred["params"][k], base["params"][k],
                                   rtol=1e-6, atol=1e-6)
    assert deferred["val_loss"] == pytest.approx(base["val_loss"], abs=1e-6)
    assert np.isfinite(deferred["val_loss"])


def test_unsupervised_trainers_with_both_flags(prefix, tmp_path):
    flags = dict(samples_1=3, samples_2=2, dim_1=6, dim_2=6, max_degree=6,
                 batch_size=16, neg_sample_size=4, max_total_steps=6,
                 print_every=3, validate_iter=3, validate_batch_size=8,
                 sampler_mode="first_k", degree_relabel=True,
                 defer_features=True)
    out = tun.train(TrainFlags(train_prefix=prefix,
                               base_log_dir=str(tmp_path / "sage"), **flags),
                    device="cpu")
    g = tio.load_data(prefix)
    with open(os.path.join(out["log_dir"], "val.txt")) as fp:
        ids = fp.read().splitlines()
    assert sorted(ids) == sorted(str(i) for i in g.node_ids)
    assert ids != [str(i) for i in g.node_ids]   # relabelled order
    rows = np.load(os.path.join(out["log_dir"], "val.npy"))
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0,
                               atol=1e-5)
    n2v = tun.train(TrainFlags(train_prefix=prefix, model="n2v",
                               learning_rate=0.5, random_context=False,
                               base_log_dir=str(tmp_path / "n2v"), **flags),
                    device="cpu")
    assert os.path.exists(os.path.join(n2v["log_dir"], "val-test.npy"))
