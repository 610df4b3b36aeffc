"""The port's power-law proxy generator (``data/synthetic.py::
make_powerlaw_graph``) and the acceptance script's ``gen_datasets``
against the JAX package's: the same spec and seed give byte-equal data
and byte-equal files, walks included. Exact equality throughout (no
tolerance): both sides make the same NumPy draws in the same order.
About 10 s on one CPU, most of it the two quick proxies."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from graphsage_tpu.data import native as jnative
from graphsage_tpu.data.synthetic import make_powerlaw_graph as jax_powerlaw
from graphsage_tpu.data.synthetic import write_dataset as jax_write
from graphsage_tpu_torch.benchmarks import accuracy_acceptance as aa
from graphsage_tpu_torch.data import native
from graphsage_tpu_torch.data.synthetic import make_powerlaw_graph
from graphsage_tpu_torch.data.synthetic import write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import benchmarks.accuracy_acceptance as jaa  # noqa: E402

DATASET_FILES = ("-G.json", "-id_map.json", "-class_map.json", "-feats.npy")

SPECS = [
    # proxy-ppi's shape, cut: dense multilabels, weak features
    dict(num_nodes=1200, num_classes=121, feat_dim=50, avg_degree=29,
         alpha=1.0, multilabel=True, feature_snr=0.5, seed=11),
    # proxy-reddit's shape, cut: single labels, strong features
    dict(num_nodes=1500, num_classes=41, feat_dim=60, avg_degree=60,
         alpha=1.0, multilabel=False, feature_snr=1.5, seed=12),
    dict(num_nodes=800, num_classes=9, feat_dim=7, avg_degree=12,
         alpha=0.8, multilabel=True, seed=12),
    dict(num_nodes=1000, num_classes=5, feat_dim=16, avg_degree=8,
         alpha=0.8, inter_frac=0.3, val_frac=0.2, test_frac=0.1, seed=11),
    # classes with no member or one: no intra-class edges drawn for them
    dict(num_nodes=30, num_classes=25, feat_dim=3, avg_degree=4,
         multilabel=True, seed=0),
]


def assert_graphs_equal(ours, theirs):
    assert ours.node_ids == theirs.node_ids
    assert ours.id2idx == theirs.id2idx
    assert ours.num_classes == theirs.num_classes
    assert ours.features.dtype == theirs.features.dtype == np.float32
    assert ours.features.tobytes() == theirs.features.tobytes()
    for field in ("edges", "is_val", "is_test", "train_removed", "labels"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert ours.class_map == theirs.class_map
    assert len(ours.neighbors) == len(theirs.neighbors)
    for a, b in zip(ours.neighbors, theirs.neighbors):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def assert_files_equal(a_prefix, b_prefix, suffixes):
    for suffix in suffixes:
        with open(a_prefix + suffix, "rb") as a, \
                open(b_prefix + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


@pytest.mark.parametrize("spec", SPECS,
                         ids=[f"spec{i}" for i in range(len(SPECS))])
def test_powerlaw_graph_byte_equal_to_jax(spec, tmp_path):
    ours, theirs = make_powerlaw_graph(**spec), jax_powerlaw(**spec)
    assert_graphs_equal(ours, theirs)
    if spec.get("multilabel"):
        labels = np.asarray([ours.class_map[n] for n in ours.node_ids])
        assert labels.shape == (spec["num_nodes"], spec["num_classes"])
        assert (labels.sum(axis=1) >= 1).all()   # its own class is on
    write_dataset(ours, str(tmp_path / "port" / "g"))
    jax_write(theirs, str(tmp_path / "jax" / "g"))
    assert_files_equal(str(tmp_path / "port" / "g"),
                       str(tmp_path / "jax" / "g"), DATASET_FILES)


def test_powerlaw_graph_is_skewed_and_split():
    spec = SPECS[1]
    g = make_powerlaw_graph(**spec)
    deg = np.asarray([len(n) for n in g.neighbors])
    # power-law propensities: hubs well above the mean degree
    assert deg.max() > 5 * deg.mean()
    assert (g.edges[:, 0] < g.edges[:, 1]).all()
    n = spec["num_nodes"]
    assert g.is_val.sum() == int(0.15 * n) and g.is_test.sum() == int(0.15 * n)
    assert not (g.is_val & g.is_test).any()
    # a different seed draws another graph
    other = make_powerlaw_graph(**dict(spec, seed=13))
    assert other.features.tobytes() != g.features.tobytes()


def test_gen_datasets_byte_equal_to_jax(tmp_path, monkeypatch):
    # Both sides take the C++ walker here: the libraries load and every
    # walk call returns from them. (The NumPy walkers of the two
    # packages draw the same pairs from the same generator too, but the
    # C++ walker draws other pairs than the NumPy one: the files can be
    # byte-equal only when both sides take the same walker.)
    assert native.available(), "the port's C++ host builder did not build"
    assert jnative._load() is not None, "native/ did not build"
    calls = {"jax": 0}
    jax_walks = jnative.native_random_walks

    def counted(*args):
        pairs = jax_walks(*args)
        assert pairs is not None
        calls["jax"] += 1
        return pairs

    monkeypatch.setattr(jnative, "native_random_walks", counted)
    before = native.native_random_walks.calls
    ours = aa.gen_datasets(str(tmp_path / "port"), quick=True)
    theirs = jaa.gen_datasets(str(tmp_path / "jax"), quick=True)
    assert native.native_random_walks.calls == before + 2
    assert calls["jax"] == 2
    assert list(ours) == list(theirs) == ["proxy-ppi", "proxy-reddit"]
    for name in ours:
        (a_prefix, a_spec), (b_prefix, b_spec) = ours[name], theirs[name]
        assert a_spec == b_spec
        assert_files_equal(a_prefix, b_prefix,
                           DATASET_FILES + ("-walks.txt",))
        with open(a_prefix + "-walks.txt") as fp:
            assert fp.readline().count("\t") == 1


def test_gen_datasets_writes_only_the_names_asked_for(tmp_path):
    out = aa.gen_datasets(str(tmp_path), quick=True, names=("proxy-ppi",))
    assert list(out) == ["proxy-ppi"]
    assert not (tmp_path / "proxy-reddit").exists()
    prefix, spec = out["proxy-ppi"]
    assert spec == aa.proxy_specs(True)["proxy-ppi"]
    for suffix in DATASET_FILES + ("-walks.txt",):
        assert os.path.getsize(prefix + suffix) > 0


def test_graph_fields_cover_the_dataclass():
    # every field assert_graphs_equal does not compare is empty on both
    g = make_powerlaw_graph(**SPECS[4])
    compared = {"node_ids", "id2idx", "num_classes", "features", "edges",
                "is_val", "is_test", "train_removed", "labels", "class_map",
                "neighbors"}
    for f in dataclasses.fields(g):
        if f.name not in compared:
            assert getattr(g, f.name) == f.default, f.name
