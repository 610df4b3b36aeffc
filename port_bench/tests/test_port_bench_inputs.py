"""The inputs: a sharded configuration's shards are the port's device
layout of the tables that the row functions make, those functions make
again the rows a shard holds, the laws hold, and an unsharded
configuration's graph and weights are bit for bit what they were."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from port_bench import inputs
from port_bench.tests.conftest import CELLS, TOY_CONFIG, toy

SEED = 3_000_000_007
CFG = dict(TOY_CONFIG, num_nodes=301, graph={"alpha": 1.05})
LAYOUTS = [(d, layout) for d in (1, 2, 4) for layout in ("strided", "block")]


def _whole(cfg):
    every = torch.arange(cfg["num_nodes"] + 1)
    return (inputs.feature_rows(cfg, SEED, every, "cpu").numpy(),
            inputs.adjacency_rows(cfg, SEED, every, "cpu").numpy(),
            inputs.label_rows(cfg, SEED, every, "cpu").numpy())


@pytest.mark.parametrize("d,layout", LAYOUTS)
def test_each_shard_is_the_ports_local_shard(d, layout):
    from graphsage_tpu_torch.parallel.graph_sharded import local_shard

    cfg = dict(CFG, graph_shards=d, shard_layout=layout)
    features, adj, labels = _whole(cfg)
    for r in range(d):
        s = inputs.make_shard(cfg, SEED, r, "cpu")
        assert (s.index, s.shards, s.layout) == (r, d, layout)
        assert s.features.shape == (inputs.shard_size(cfg), 12)
        assert np.array_equal(s.features.numpy().view(np.int32),
                              local_shard(features, d, r, layout).view(
                                  np.int32))
        assert np.array_equal(s.adj.numpy(), local_shard(adj, d, r, layout))
        assert np.array_equal(s.labels.numpy(), labels)


@pytest.mark.parametrize("d,layout", LAYOUTS)
def test_rows_made_again_are_the_rows_a_shard_holds(d, layout):
    cfg = dict(CFG, graph_shards=d, shard_layout=layout)
    shards = [inputs.make_shard(cfg, SEED, r, "cpu") for r in range(d)]
    ids = torch.as_tensor(np.random.default_rng(d).integers(
        0, cfg["num_nodes"] + 1, 500))
    ss = inputs.shard_size(cfg)
    owner, local = ((ids % d, ids // d) if layout == "strided"
                    else (ids // ss, ids % ss))
    held_f = torch.stack([shards[o].features[i] for o, i in zip(owner, local)])
    held_a = torch.stack([shards[o].adj[i] for o, i in zip(owner, local)])
    assert torch.equal(
        inputs.feature_rows(cfg, SEED, ids, "cpu").view(torch.int32),
        held_f.view(torch.int32))
    assert torch.equal(inputs.adjacency_rows(cfg, SEED, ids, "cpu"), held_a)
    assert torch.equal(inputs.label_rows(cfg, SEED, ids, "cpu"),
                       shards[0].labels[ids])


def test_the_laws_and_the_dummy():
    cfg = dict(CFG, num_nodes=20_000, feature_dim=64, max_degree=32)
    n = cfg["num_nodes"]
    features, adj, labels = _whole(cfg)
    z = features[:n].ravel().astype(np.float64)
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    assert abs((z ** 4).mean() - 3.0) < 0.05
    pmf = np.arange(1, n + 1, dtype=np.float64) ** -1.05
    pmf /= pmf.sum()
    seen = np.bincount(adj[:n].ravel(), minlength=n) / adj[:n].size
    assert np.abs(seen[:5] - pmf[:5]).max() < 0.005
    assert adj[:n].max() < n
    counts = np.bincount(labels[:n], minlength=cfg["num_classes"])
    assert counts.min() > 0.9 * n / cfg["num_classes"]
    assert not features[n].any() and (adj[n] == n).all() and labels[n] == -1
    # another seed, other tables
    assert not np.array_equal(
        inputs.adjacency_rows(cfg, SEED + 1, torch.arange(10), "cpu"),
        adj[:10])


# sha256 of make_graph's tables and of make_params at the toy size, seed
# SEED, recorded before the sharded inputs were added
DIGESTS = {
    "meanpool-reddit-train": (
        "09755dd90b4b4975f2d65b7a92ad9effb393025880276a6929ffc4a0dd58ece5",
        "832c82f75c370fb890f7827644a4f07a0b06ff28891b7fb3e85dfc58135cd2da"),
    "mean-reddit-sweep": (
        "09755dd90b4b4975f2d65b7a92ad9effb393025880276a6929ffc4a0dd58ece5",
        "fd0ab607f751900a222bf7c20fca73c905c3b319016fed5068f9d026329102f1"),
    "meanpool-reddit-requests": (
        "09755dd90b4b4975f2d65b7a92ad9effb393025880276a6929ffc4a0dd58ece5",
        "832c82f75c370fb890f7827644a4f07a0b06ff28891b7fb3e85dfc58135cd2da"),
}


@pytest.mark.parametrize("name", CELLS)
def test_unsharded_inputs_are_as_they_were(name):
    cfg = toy(name).config
    assert inputs.shards(cfg) == 1
    g = inputs.make_graph(cfg, SEED, "cpu")
    graph = hashlib.sha256()
    for t in (g.features, g.adj, g.labels_table):
        graph.update(t.contiguous().numpy().tobytes())
    params = hashlib.sha256()
    for k, v in inputs.make_params(cfg, SEED, "cpu").items():
        params.update(k.encode())
        params.update(v.contiguous().numpy().tobytes())
    assert (graph.hexdigest(), params.hexdigest()) == DIGESTS[name]
