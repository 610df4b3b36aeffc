"""The port's data layer against graphsage_tpu/data: the loader and the
padded adjacency on example_data/toy-ppi (both sides on their NumPy
paths, with the C++ builders switched off; tests/test_torch_native.py
holds the two C++ paths to each other), and the synthetic fixtures."""

import os

import numpy as np
import pytest

from graphsage_tpu.data import adjacency as jax_adjacency
from graphsage_tpu.data import native as jax_native
from graphsage_tpu.data.io import load_data as jax_load_data
from graphsage_tpu.data.synthetic import (
    make_synthetic_graph as jax_make_synthetic_graph,
)
from graphsage_tpu_torch.data import native
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)

TOY_PPI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "example_data", "toy-ppi")
FIELDS = ("features", "labels", "is_val", "is_test", "edges",
          "train_removed")


def _assert_same_graph(a, b):
    assert a.node_ids == b.node_ids
    assert a.id2idx == b.id2idx
    assert a.num_classes == b.num_classes
    assert a.class_map == b.class_map
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert len(a.neighbors) == len(b.neighbors)
    for x, y in zip(a.neighbors, b.neighbors):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.padded_features(), b.padded_features())


@pytest.fixture()
def jax_numpy_path(monkeypatch):
    """Both adjacency builders without their C++ fast paths, which draw
    other neighbors than the NumPy paths."""
    monkeypatch.setattr(jax_native, "native_pad_adjacency",
                        lambda *a, **k: None)
    monkeypatch.setattr(native, "native_pad_adjacency",
                        lambda *a, **k: None)


@pytest.mark.parametrize("max_degree", [10, 128])
def test_toy_ppi_load_and_adjacency_match_jax(jax_numpy_path, max_degree):
    graph = load_data(TOY_PPI)
    ref = jax_load_data(TOY_PPI)
    _assert_same_graph(graph, ref)
    ours = build_both_adjs(graph, max_degree, seed=3)
    theirs = jax_adjacency.build_both_adjs(ref, max_degree, seed=3)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    train_adj, _, full_adj = ours
    n = graph.num_nodes
    assert full_adj.shape == (n + 1, max_degree)
    assert (full_adj[n] == n).all()          # the dummy points at itself
    assert (train_adj[:n][graph.is_val | graph.is_test] == n).all()


@pytest.mark.parametrize("multilabel", [False, True])
def test_synthetic_graph_and_written_dataset_match_jax(tmp_path, multilabel):
    graph = make_synthetic_graph(num_nodes=90, num_classes=4, feat_dim=6,
                                 multilabel=multilabel, seed=9)
    _assert_same_graph(graph, jax_make_synthetic_graph(
        num_nodes=90, num_classes=4, feat_dim=6, multilabel=multilabel,
        seed=9))
    prefix = str(tmp_path / "syn" / "syn")
    write_dataset(graph, prefix)
    loaded = load_data(prefix)
    _assert_same_graph(loaded, jax_load_data(prefix))
    np.testing.assert_array_equal(loaded.edges, graph.edges)
    raw = load_data(prefix, normalize=False)
    np.testing.assert_array_equal(raw.features, graph.features)
