"""The port's C++ host builder (graphsage_tpu_torch/data/native.py)
against the JAX package's (graphsage_tpu/data/native.py): the same
source, the same padded adjacency and walk pairs bit for bit for the
same seeds, and the NumPy paths when the library is unavailable."""

import os

import numpy as np
import pytest

from graphsage_tpu.data import adjacency as jadj
from graphsage_tpu.data import native as jnative
from graphsage_tpu.data import walks as jwalks
from graphsage_tpu_torch.data import adjacency as tadj
from graphsage_tpu_torch.data import native
from graphsage_tpu_torch.data import walks as twalks
from graphsage_tpu_torch.data.synthetic import make_synthetic_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_graph(num_nodes=300, num_classes=3, feat_dim=4,
                                seed=7)


def test_source_is_a_byte_identical_copy():
    with open(os.path.join(ROOT, "native", "graph_builder.cpp"), "rb") as a:
        with open(native.SOURCE, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("max_degree,seed", [(4, 0), (12, 5), (40, 123)])
def test_pad_adjacency_bit_equal_to_jax(graph, max_degree, seed):
    n = graph.num_nodes
    for nbrs in (graph.neighbors, graph.train_neighbors()):
        ours = native.native_pad_adjacency(nbrs, n, max_degree, seed)
        theirs = jnative.native_pad_adjacency(nbrs, n, max_degree, seed)
        assert ours is not None and theirs is not None
        assert ours.dtype == np.int32 and ours.shape == (n + 1, max_degree)
        np.testing.assert_array_equal(ours, theirs)
    # through the builders, one generator draw as the seed
    for a, b in zip(tadj.build_both_adjs(graph, max_degree, seed=seed),
                    jadj.build_both_adjs(graph, max_degree, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_walks,walk_len,seed", [(3, 5, 0), (1, 1, 4),
                                                     (7, 3, 99)])
def test_random_walks_bit_equal_to_jax(graph, num_walks, walk_len, seed):
    nodes = np.flatnonzero(graph.is_train).astype(np.int32)
    ours = native.native_random_walks(graph.neighbors, nodes, num_walks,
                                      walk_len, seed)
    theirs = jnative.native_random_walks(graph.neighbors, nodes, num_walks,
                                         walk_len, seed)
    assert ours is not None and ours.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        twalks.run_random_walks(graph.neighbors, nodes, num_walks, walk_len,
                                np.random.default_rng(seed)),
        jwalks.run_random_walks(graph.neighbors, nodes, num_walks, walk_len,
                                np.random.default_rng(seed)))
    if walk_len > 1:
        assert len(ours) > 0 and (ours[:, 0] != ours[:, 1]).all()


def test_native_calls_are_counted(graph):
    before = (native.native_pad_adjacency.calls,
              native.native_random_walks.calls)
    tadj.build_both_adjs(graph, 6, seed=1)
    twalks.run_random_walks(graph.neighbors, np.arange(5), 2, 3,
                            np.random.default_rng(0))
    assert (native.native_pad_adjacency.calls,
            native.native_random_walks.calls) == (before[0] + 2,
                                                  before[1] + 1)


def test_without_the_library_the_numpy_paths_run(graph, monkeypatch,
                                                 tmp_path, capfd):
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert not native.available()
    nbrs = graph.train_neighbors()
    adj, deg = tadj.pad_neighbor_lists(nbrs, graph.num_nodes, 8,
                                       np.random.default_rng(3))
    rng = np.random.default_rng(3)
    rng.integers(0, 2**31 - 1)   # the seed draw both packages spend
    np.testing.assert_array_equal(
        adj, tadj.numpy_pad_neighbor_lists(nbrs, graph.num_nodes, 8, rng))
    nodes = np.flatnonzero(graph.is_train)
    pairs = twalks.run_random_walks(nbrs, nodes, 2, 4,
                                    np.random.default_rng(8))
    np.testing.assert_array_equal(
        pairs, jwalks._python_random_walks(
            nbrs, nodes, 2, 4, _after_seed_draw(np.random.default_rng(8))))
    err = capfd.readouterr().err
    assert err.count("the C++ host builder is unavailable") == 1


def _after_seed_draw(rng):
    rng.integers(0, 2**31 - 1)
    return rng
