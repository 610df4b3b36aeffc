"""Deterministic synthetic graph fixtures, written in the on-disk
dataset contract so that the loader path is exercised.

The same seed gives the same graph as ``graphsage_tpu``'s fixtures of
the same names: the draws are identical NumPy calls in the same order.
"""

from __future__ import annotations

import json
import os

import numpy as np

from graphsage_tpu_torch.data.graph import GraphData, dense_labels


def make_synthetic_graph(
    num_nodes: int = 200,
    num_classes: int = 4,
    feat_dim: int = 16,
    intra_p: float = 0.15,
    inter_p: float = 0.01,
    multilabel: bool = False,
    val_frac: float = 0.15,
    test_frac: float = 0.15,
    seed: int = 0,
) -> GraphData:
    """Community graph: nodes in the same class connect with prob intra_p,
    across classes inter_p; features = one-hot(class) signal + noise."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, num_classes, size=num_nodes)

    if num_nodes <= 2000:
        edges = []
        for i in range(num_nodes):
            for j in range(i + 1, num_nodes):
                p = intra_p if classes[i] == classes[j] else inter_p
                if rng.random() < p:
                    edges.append((i, j))
        edge_arr = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    else:
        edge_arr = _sample_partition_edges(
            rng, classes, num_nodes, num_classes, intra_p, inter_p
        )

    feats = rng.normal(0, 1.0, size=(num_nodes, feat_dim)).astype(np.float32)
    feats[np.arange(num_nodes), classes % feat_dim] += 3.0

    order = rng.permutation(num_nodes)
    n_val = int(val_frac * num_nodes)
    n_test = int(test_frac * num_nodes)
    is_val = np.zeros(num_nodes, dtype=bool)
    is_test = np.zeros(num_nodes, dtype=bool)
    is_val[order[:n_val]] = True
    is_test[order[n_val:n_val + n_test]] = True

    train_removed = (
        is_val[edge_arr[:, 0]] | is_test[edge_arr[:, 0]]
        | is_val[edge_arr[:, 1]] | is_test[edge_arr[:, 1]]
    )

    neighbors: list[list[int]] = [[] for _ in range(num_nodes)]
    for a, b in edge_arr:
        neighbors[a].append(b)
        neighbors[b].append(a)
    neighbors = [np.asarray(x, dtype=np.int32) for x in neighbors]

    node_ids = [str(i) for i in range(num_nodes)]
    if multilabel:
        class_map = {}
        for i, nid in enumerate(node_ids):
            vec = [0] * num_classes
            vec[int(classes[i])] = 1
            vec[int((classes[i] + 1) % num_classes)] = int(rng.random() < 0.3)
            class_map[nid] = vec
    else:
        class_map = {nid: int(classes[i]) for i, nid in enumerate(node_ids)}

    return GraphData(
        node_ids=node_ids,
        id2idx={nid: i for i, nid in enumerate(node_ids)},
        features=feats,
        class_map=class_map,
        labels=dense_labels(class_map, node_ids, num_classes),
        num_classes=num_classes,
        is_val=is_val,
        is_test=is_test,
        edges=edge_arr,
        train_removed=train_removed,
        neighbors=neighbors,
    )


def _sample_partition_edges(rng, classes, num_nodes, num_classes,
                            intra_p, inter_p):
    """Planted-partition edges for large graphs: draw the expected number
    of intra-/inter-class pairs directly instead of the O(N^2) sweep."""
    chunks = []
    for c in range(num_classes):
        members = np.flatnonzero(classes == c)
        m = len(members)
        n_intra = rng.poisson(intra_p * m * (m - 1) / 2)
        if n_intra and m > 1:
            a = members[rng.integers(0, m, n_intra)]
            b = members[rng.integers(0, m, n_intra)]
            chunks.append(np.stack([a, b], axis=1))
    n_inter = rng.poisson(inter_p * num_nodes * (num_nodes - 1) / 2)
    if n_inter:
        a = rng.integers(0, num_nodes, n_inter)
        b = rng.integers(0, num_nodes, n_inter)
        chunks.append(np.stack([a, b], axis=1))
    if not chunks:
        return np.zeros((0, 2), dtype=np.int32)
    pairs = np.concatenate(chunks, axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    keys = np.unique(lo * num_nodes + hi)
    return np.stack(
        [keys // num_nodes, keys % num_nodes], axis=1
    ).astype(np.int32)


def make_powerlaw_graph(
    num_nodes: int = 15_000,
    num_classes: int = 41,
    feat_dim: int = 602,
    avg_degree: float = 30.0,
    alpha: float = 1.0,
    inter_frac: float = 0.15,
    feature_snr: float = 1.0,
    multilabel: bool = False,
    val_frac: float = 0.15,
    test_frac: float = 0.15,
    seed: int = 0,
) -> GraphData:
    """Degree-corrected planted-partition graph (DC-SBM): power-law
    degree propensities (zipf ``alpha`` over a random within-class rank)
    and community-aligned labels, the degree skew (hubs) that real
    PPI/Reddit graphs have and the uniform community fixture hides.

    ``inter_frac`` of the edges cross communities; the features carry a
    class signature scaled by ``feature_snr`` over unit noise, so
    aggregating over (mostly same-class) neighborhoods denoises them.
    With ``multilabel`` each community takes a Bernoulli(0.3) signature
    over the label set (PPI's ~30% label density) and each node its
    community's signature with 10% of its labels flipped, its own class
    always positive.
    """
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, num_classes, size=num_nodes)

    theta = np.empty(num_nodes, dtype=np.float64)
    for c in range(num_classes):
        members = np.flatnonzero(classes == c)
        ranks = rng.permutation(len(members)) + 1
        theta[members] = ranks ** -alpha
    n_edges = int(avg_degree * num_nodes / 2)

    def draw(members, size):
        p = theta[members] / theta[members].sum()
        return members[rng.choice(len(members), size=size, p=p)]

    chunks = []
    n_inter = int(n_edges * inter_frac)
    all_nodes = np.arange(num_nodes)
    chunks.append(np.stack(
        [draw(all_nodes, n_inter), draw(all_nodes, n_inter)], axis=1
    ))
    per_class = rng.multinomial(
        n_edges - n_inter,
        np.bincount(classes, weights=theta, minlength=num_classes)
        / theta.sum(),
    )
    for c in range(num_classes):
        members = np.flatnonzero(classes == c)
        if len(members) > 1 and per_class[c] > 0:
            chunks.append(np.stack(
                [draw(members, per_class[c]), draw(members, per_class[c])],
                axis=1,
            ))
    pairs = np.concatenate(chunks, axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    lo = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    hi = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    keys = np.unique(lo * num_nodes + hi)
    edge_arr = np.stack(
        [keys // num_nodes, keys % num_nodes], axis=1
    ).astype(np.int32)

    feats = rng.normal(0, 1.0, size=(num_nodes, feat_dim)).astype(
        np.float32
    )
    proto = rng.normal(0, 1.0, size=(num_classes, feat_dim)).astype(
        np.float32
    )
    proto /= np.linalg.norm(proto, axis=1, keepdims=True)
    feats += feature_snr * proto[classes]

    order = rng.permutation(num_nodes)
    n_val = int(val_frac * num_nodes)
    n_test = int(test_frac * num_nodes)
    is_val = np.zeros(num_nodes, dtype=bool)
    is_test = np.zeros(num_nodes, dtype=bool)
    is_val[order[:n_val]] = True
    is_test[order[n_val:n_val + n_test]] = True

    train_removed = (
        is_val[edge_arr[:, 0]] | is_test[edge_arr[:, 0]]
        | is_val[edge_arr[:, 1]] | is_test[edge_arr[:, 1]]
    )
    flat = np.concatenate([edge_arr, edge_arr[:, ::-1]], axis=0)
    srt = flat[np.argsort(flat[:, 0], kind="stable")]
    starts = np.searchsorted(srt[:, 0], np.arange(num_nodes + 1))
    neighbors = [srt[starts[i]:starts[i + 1], 1].astype(np.int32)
                 for i in range(num_nodes)]

    node_ids = [str(i) for i in range(num_nodes)]
    if multilabel:
        signatures = rng.random((num_classes, num_classes)) < 0.3
        flips = rng.random((num_nodes, num_classes)) < 0.1
        label_mat = signatures[classes] ^ flips
        label_mat[np.arange(num_nodes), classes] = True
        class_map = {
            nid: [int(v) for v in label_mat[i]]
            for i, nid in enumerate(node_ids)
        }
    else:
        class_map = {nid: int(classes[i]) for i, nid in enumerate(node_ids)}

    return GraphData(
        node_ids=node_ids,
        id2idx={nid: i for i, nid in enumerate(node_ids)},
        features=feats,
        class_map=class_map,
        labels=dense_labels(class_map, node_ids, num_classes),
        num_classes=num_classes,
        is_val=is_val,
        is_test=is_test,
        edges=edge_arr,
        train_removed=train_removed,
        neighbors=neighbors,
    )


def write_dataset(graph: GraphData, prefix: str) -> None:
    """Write a GraphData in the public on-disk contract:
    -G.json / -id_map.json / -class_map.json / -feats.npy."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    nodes = [
        {
            "id": nid,
            "val": bool(graph.is_val[i]),
            "test": bool(graph.is_test[i]),
        }
        for i, nid in enumerate(graph.node_ids)
    ]
    links = [
        {"source": int(a), "target": int(b)} for a, b in graph.edges
    ]
    with open(prefix + "-G.json", "w") as fp:
        json.dump(
            {
                "directed": False,
                "multigraph": False,
                "nodes": nodes,
                "links": links,
            },
            fp,
        )
    with open(prefix + "-id_map.json", "w") as fp:
        json.dump({nid: i for i, nid in enumerate(graph.node_ids)}, fp)
    if graph.class_map is not None:
        with open(prefix + "-class_map.json", "w") as fp:
            json.dump({str(k): v for k, v in graph.class_map.items()}, fp)
    if graph.features is not None:
        np.save(prefix + "-feats.npy", graph.features)
