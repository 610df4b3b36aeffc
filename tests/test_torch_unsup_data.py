"""The port's unsupervised data layer against the JAX package's: the
Python walker (the same pairs as JAX's for the same NumPy generator),
the walks file, ``load_data(load_walks=True)`` and the
``EdgeBatcher``'s train, val, sampled-val and embedding batches, over
walk pairs and over raw edges. All exact."""

import warnings

import numpy as np
import pytest

from graphsage_tpu.data import io as jio
from graphsage_tpu.data import walks as jwalks
from graphsage_tpu.data.minibatch import EdgeBatcher as JaxEdgeBatcher
from graphsage_tpu_torch.data import walks as twalks
from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data
from graphsage_tpu_torch.data.minibatch import EdgeBatcher
from graphsage_tpu_torch.data.synthetic import (
    make_synthetic_graph,
    write_dataset,
)


@pytest.fixture(scope="module")
def graph():
    return make_synthetic_graph(num_nodes=90, num_classes=3, feat_dim=6,
                                seed=5)


def _train_subgraph(g):
    is_train = g.is_train
    return [nbrs[is_train[nbrs]] if is_train[i] else nbrs[:0]
            for i, nbrs in enumerate(g.neighbors)]


@pytest.mark.parametrize("num_walks,walk_len,seed", [(3, 5, 0), (2, 1, 7),
                                                     (4, 3, 11)])
def test_walks_match_jax_python_walker(graph, num_walks, walk_len, seed):
    nbrs = _train_subgraph(graph)
    nodes = np.flatnonzero(graph.is_train)
    ours = twalks.python_random_walks(nbrs, nodes, num_walks, walk_len,
                                      np.random.default_rng(seed))
    theirs = jwalks._python_random_walks(nbrs, nodes, num_walks, walk_len,
                                         np.random.default_rng(seed))
    assert ours.dtype == np.int32 and ours.shape[1] == 2
    np.testing.assert_array_equal(ours, theirs)
    if walk_len > 1:
        assert len(ours) > 0 and (ours[:, 0] != ours[:, 1]).all()
    else:   # a walk of one step visits only its start
        assert len(ours) == 0


def test_walks_file_round_trip(tmp_path, graph):
    pairs = twalks.run_random_walks(_train_subgraph(graph),
                                    np.flatnonzero(graph.is_train), 2, 4,
                                    np.random.default_rng(1))
    path = str(tmp_path / "w.txt")
    twalks.write_walks(path, pairs, graph.node_ids)
    np.testing.assert_array_equal(twalks.read_walks(path, graph.id2idx),
                                  pairs)
    np.testing.assert_array_equal(jwalks.read_walks(path, graph.id2idx),
                                  pairs)
    jpath = str(tmp_path / "jw.txt")
    jwalks.write_walks(jpath, pairs, graph.node_ids)
    assert open(jpath).read() == open(path).read()


def test_load_data_with_walks_matches_jax(tmp_path, graph):
    prefix = str(tmp_path / "toy" / "toy")
    write_dataset(graph, prefix)
    pairs = twalks.run_random_walks(_train_subgraph(graph),
                                    np.flatnonzero(graph.is_train), 2, 4,
                                    np.random.default_rng(2))
    twalks.write_walks(prefix + "-walks.txt", pairs, graph.node_ids)
    ours = load_data(prefix, load_walks=True)
    theirs = jio.load_data(prefix, load_walks=True)
    np.testing.assert_array_equal(ours.walks, theirs.walks)
    np.testing.assert_array_equal(ours.walks, pairs)
    np.testing.assert_array_equal(ours.edges, theirs.edges)
    assert load_data(prefix).walks is None


def _batchers(graph, walks: bool, batch_size=8, **kw):
    _, deg, _ = build_both_adjs(graph, 6, seed=3)
    pairs = None
    if walks:
        pairs = twalks.run_random_walks(_train_subgraph(graph),
                                        np.flatnonzero(graph.is_train), 2,
                                        4, np.random.default_rng(4))
    return (EdgeBatcher(graph, deg, batch_size, context_pairs=pairs, seed=9,
                        **kw),
            JaxEdgeBatcher(graph, deg, batch_size, context_pairs=pairs,
                           seed=9, **kw), deg)


def _same_batch(a, b):
    for name in ("batch1", "batch2", "mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("walks", [True, False])
def test_edge_batcher_matches_jax(graph, walks):
    ours, theirs, deg = _batchers(graph, walks)
    np.testing.assert_array_equal(ours.train_pairs, theirs.train_pairs)
    np.testing.assert_array_equal(ours.val_pairs, theirs.val_pairs)
    assert ours.num_batches() == theirs.num_batches()
    assert (deg[ours.train_pairs] > 0).all()
    assert len(ours.val_pairs) == int(graph.train_removed.sum())
    # sampled val batches, one draw after another from the same stream
    for size in (5, 8, 0, -1, 3):
        _same_batch(ours.sample_val_batch(size),
                    theirs.sample_val_batch(size))
    ours_e, theirs_e = list(ours.embed_batches()), list(theirs.embed_batches())
    assert len(ours_e) == len(theirs_e) == -(-graph.num_nodes // 8)
    for a, b in zip(ours_e, theirs_e):
        _same_batch(a, b)
    np.testing.assert_array_equal(ours_e[-1].batch1[ours_e[-1].mask == 0],
                                  graph.num_nodes)


def test_oversized_val_batch_warns_and_takes_one_batch(graph):
    ours, theirs, _ = _batchers(graph, False)
    with pytest.warns(UserWarning, match="exceeds batch_size"):
        a = ours.sample_val_batch(20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = theirs.sample_val_batch(20)
    _same_batch(a, b)
    assert a.mask.sum() == 8


@pytest.mark.parametrize("fixed_n2v", [False, True])
def test_edge_batcher_n2v_retrain_matches_jax(graph, fixed_n2v):
    ours, theirs, _ = _batchers(graph, True, n2v_retrain=True,
                                fixed_n2v=fixed_n2v)
    np.testing.assert_array_equal(ours.train_pairs, theirs.train_pairs)
    np.testing.assert_array_equal(ours.val_pairs, theirs.val_pairs)
    if fixed_n2v:
        is_eval = graph.is_val | graph.is_test
        assert not is_eval[ours.train_pairs[:, 1]].any()
