"""Dataset loader for the public GraphSAGE on-disk contract.

Reads ``<prefix>-G.json`` (networkx node-link format),
``<prefix>-id_map.json``, ``<prefix>-class_map.json``, an optional
``<prefix>-feats.npy`` and, on request, ``<prefix>-walks.txt`` without
a networkx dependency. Semantics:

  * nodes missing ``val``/``test`` annotations are dropped
  * every edge touching a val/test endpoint is flagged ``train_removed``
  * features are standardized with mean/std fitted on train rows only

``load_features=False`` defers the feature table (``load_feature_rows``
and ``materialize_features`` read it later), and ``degree_relabel``
renumbers the nodes by descending degree (``relabel_by_degree``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from graphsage_tpu_torch.data.graph import (
    GraphData,
    dense_labels,
    infer_num_classes,
)
from graphsage_tpu_torch.data.walks import read_walks


def _node_key_conversion(sample_key):
    """id_map / class_map keys may be stringified ints."""
    if isinstance(sample_key, int):
        return int
    return lambda x: x


def parse_node_link_graph(g_data: dict):
    """Parse a node-link dict into (node_ids, is_val, is_test, has_flags,
    edges_by_position).

    networkx 1.x writes ``links`` whose source/target are positions in
    the ``nodes`` list; networkx >= 2 writes ids. Both are accepted.
    """
    nodes = g_data["nodes"]
    links = g_data.get("links", g_data.get("edges", []))

    node_ids = [nd.get("id") for nd in nodes]
    is_val = np.array([bool(nd.get("val", False)) for nd in nodes])
    is_test = np.array([bool(nd.get("test", False)) for nd in nodes])
    has_flags = np.array(
        [("val" in nd) and ("test" in nd) for nd in nodes], dtype=bool
    )

    n = len(nodes)
    ids_are_ints = all(isinstance(i, (int, np.integer)) for i in node_ids)
    srcs = [lk["source"] for lk in links]
    tgts = [lk["target"] for lk in links]
    all_int_refs = all(isinstance(s, (int, np.integer)) for s in srcs + tgts)
    if all_int_refs and (
        not ids_are_ints or _looks_positional(srcs, tgts, n)
    ):
        edges = np.array(list(zip(srcs, tgts)), dtype=np.int64).reshape(-1, 2)
    else:
        idx_of = {nid: i for i, nid in enumerate(node_ids)}
        edges = np.array(
            [(idx_of[s], idx_of[t]) for s, t in zip(srcs, tgts)],
            dtype=np.int64,
        ).reshape(-1, 2)
    return node_ids, is_val, is_test, has_flags, edges


def _looks_positional(srcs, tgts, n) -> bool:
    """With integer node ids, positional and id refs are only
    distinguishable when ids are not 0..n-1 in order; prefer positional
    (the nx 1.x writer) whenever all refs are in range."""
    if not srcs:
        return True
    lo = min(min(srcs), min(tgts))
    hi = max(max(srcs), max(tgts))
    return lo >= 0 and hi < n


def load_data(prefix: str, normalize: bool = True,
              load_walks: bool = False, load_features: bool = True,
              degree_relabel: bool = False) -> GraphData:
    """Load a dataset into a :class:`GraphData` (see module docstring);
    ``load_walks`` also reads the walk pairs. ``load_features=False``
    leaves ``features`` None and records the table on disk in
    ``feature_meta``/``feat_rows``; ``degree_relabel`` applies
    :func:`relabel_by_degree`."""
    with open(prefix + "-G.json") as fp:
        g_data = json.load(fp)
    node_ids, is_val, is_test, has_flags, edges = parse_node_link_graph(g_data)

    with open(prefix + "-id_map.json") as fp:
        raw_id_map = json.load(fp)
    conv = _node_key_conversion(node_ids[0] if node_ids else "")
    id_map = {conv(k): int(v) for k, v in raw_id_map.items()}

    class_map = None
    class_path = prefix + "-class_map.json"
    if os.path.exists(class_path):
        with open(class_path) as fp:
            raw_class_map = json.load(fp)
        first_label = next(iter(raw_class_map.values()))
        lab_conv = (lambda x: x) if isinstance(first_label, list) else int
        class_map = {conv(k): lab_conv(v) for k, v in raw_class_map.items()}

    feats = None
    feats_path = prefix + "-feats.npy"
    have_feats = os.path.exists(feats_path)
    if have_feats and load_features:
        feats = np.load(feats_path).astype(np.float32)

    # Drop nodes missing val/test annotations, then reindex every node to
    # its id_map position so arrays align with the feature file.
    keep_positions = np.flatnonzero(has_flags)
    kept_ids = [node_ids[p] for p in keep_positions]
    n = len(kept_ids)
    order = sorted(range(n), key=lambda j: id_map[kept_ids[j]])
    ordered_ids = [kept_ids[j] for j in order]
    new_index_of_position = {
        keep_positions[j]: new_idx for new_idx, j in enumerate(order)
    }
    new_is_val = np.array(
        [is_val[keep_positions[j]] for j in order], dtype=bool
    )
    new_is_test = np.array(
        [is_test[keep_positions[j]] for j in order], dtype=bool
    )
    feat_rows = feature_meta = None
    if have_feats:
        feat_rows = np.array([id_map[nid] for nid in ordered_ids])
        if feats is not None:
            feats = feats[feat_rows]
        else:
            shape = np.load(feats_path, mmap_mode="r").shape
            feature_meta = (feats_path, int(shape[0]), int(shape[1]))

    # Remap edges, dropping those touching removed nodes; dedupe (undirected).
    remapped = []
    seen = set()
    for a, b in edges:
        if a not in new_index_of_position or b not in new_index_of_position:
            continue
        i, j = new_index_of_position[a], new_index_of_position[b]
        if i == j:
            continue
        key = (i, j) if i < j else (j, i)
        if key in seen:
            continue
        seen.add(key)
        remapped.append(key)
    edge_arr = np.array(remapped, dtype=np.int32).reshape(-1, 2)

    train_removed = (
        new_is_val[edge_arr[:, 0]] | new_is_test[edge_arr[:, 0]]
        | new_is_val[edge_arr[:, 1]] | new_is_test[edge_arr[:, 1]]
    )

    if normalize and feats is not None:
        feats = standardize_features(feats, ~(new_is_val | new_is_test))

    labels = None
    num_classes = None
    if class_map is not None:
        num_classes = infer_num_classes(class_map)
        labels = dense_labels(class_map, ordered_ids, num_classes)

    id2idx = {nid: i for i, nid in enumerate(ordered_ids)}
    graph = GraphData(
        node_ids=ordered_ids,
        id2idx=id2idx,
        features=feats,
        class_map=class_map,
        labels=labels,
        num_classes=num_classes,
        is_val=new_is_val,
        is_test=new_is_test,
        edges=edge_arr,
        train_removed=train_removed,
        neighbors=_build_neighbor_lists(n, edge_arr),
        walks=(read_walks(prefix + "-walks.txt", id2idx) if load_walks
               else None),
        feat_rows=feat_rows,
        feature_meta=feature_meta,
        feature_normalize=normalize,
    )
    return relabel_by_degree(graph) if degree_relabel else graph


def relabel_by_degree(graph: GraphData) -> GraphData:
    """The graph with its node indices renumbered by descending degree
    (ties by the old index): hub rows become the low, dense rows of the
    feature table. Every array is re-indexed alike and the original ids
    still map through ``node_ids``/``id2idx``, so walks, exports and
    evaluation are unchanged as sets."""
    n = graph.num_nodes
    deg = np.fromiter((len(v) for v in graph.neighbors), count=n,
                      dtype=np.int64)
    order = np.argsort(-deg, kind="stable")      # new index -> old index
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)                   # old index -> new index
    node_ids = [graph.node_ids[o] for o in order]
    return dataclasses.replace(
        graph,
        node_ids=node_ids,
        id2idx={nid: i for i, nid in enumerate(node_ids)},
        features=(graph.features[order]
                  if graph.features is not None else None),
        labels=graph.labels[order] if graph.labels is not None else None,
        is_val=graph.is_val[order],
        is_test=graph.is_test[order],
        edges=perm[graph.edges].astype(np.int32),
        neighbors=[perm[graph.neighbors[o]].astype(np.int32)
                   for o in order],
        walks=(perm[graph.walks].astype(np.int32)
               if graph.walks is not None else None),
        feat_rows=(graph.feat_rows[order]
                   if graph.feat_rows is not None else None),
    )


def feature_stats(graph: GraphData, chunk: int = 65536):
    """(mean, std) float32 over the train rows of a deferred table, in
    chunks of ``chunk`` rows of the memory-mapped file with float64 sums:
    the population std of ``standardize_features``, 0 replaced by 1."""
    path, _, width = graph.feature_meta
    mm = np.load(path, mmap_mode="r")
    train_rows = np.sort(graph.feat_rows[graph.is_train])
    s = np.zeros(width, np.float64)
    ss = np.zeros(width, np.float64)
    for i in range(0, len(train_rows), chunk):
        block = np.asarray(mm[train_rows[i:i + chunk]], dtype=np.float64)
        s += block.sum(axis=0)
        ss += (block * block).sum(axis=0)
    cnt = max(len(train_rows), 1)
    mean = s / cnt
    std = np.sqrt(np.maximum(ss / cnt - mean * mean, 0.0))
    std[std == 0.0] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def load_feature_rows(graph: GraphData, node_ids: np.ndarray,
                      normalize: bool | None = None, stats=None,
                      dtype=np.float32, chunk: int = 65536) -> np.ndarray:
    """Rows ``node_ids`` of the (standardized) feature table, read from
    the deferred table on disk and nothing else; ids >= num_nodes (the
    dummy) give zero rows. ``normalize=None`` keeps load_data's intent;
    ``stats`` are ``feature_stats``' (computed when not given)."""
    if graph.feature_meta is None:
        raise ValueError(
            "load_feature_rows needs a deferred feature table: load the "
            "graph with load_data(..., load_features=False)")
    if normalize is None:
        normalize = graph.feature_normalize
    path, _, width = graph.feature_meta
    mm = np.load(path, mmap_mode="r")
    node_ids = np.asarray(node_ids)
    out = np.zeros((len(node_ids), width), dtype=np.float32)
    real = node_ids < graph.num_nodes
    if real.any():
        out[real] = mm[graph.feat_rows[node_ids[real]]]
        if normalize:
            mean, std = (stats if stats is not None
                         else feature_stats(graph, chunk))
            out[real] = (out[real] - mean) / std
    return out.astype(dtype)


def load_feature_shard(graph: GraphData, lo: int, hi: int,
                       normalize: bool | None = None, stats=None,
                       dtype=np.float32, chunk: int = 65536) -> np.ndarray:
    """Rows [lo, hi) of the padded feature table (``load_feature_rows``
    of that range)."""
    return load_feature_rows(graph, np.arange(lo, hi), normalize=normalize,
                             stats=stats, dtype=dtype, chunk=chunk)


def materialize_features(graph: GraphData) -> GraphData:
    """The graph with its feature table in memory: a deferred table is
    read whole into a copy of ``graph`` (the caller's stays deferred);
    a graph already in memory, or without features, passes through."""
    if graph.features is not None or graph.feature_meta is None:
        return graph
    return dataclasses.replace(
        graph, features=load_feature_shard(graph, 0, graph.num_nodes))


def standardize_features(feats: np.ndarray,
                         train_mask: np.ndarray) -> np.ndarray:
    """StandardScaler semantics fitted on train rows only (population
    std; zero std columns are left unscaled)."""
    train_rows = feats[train_mask]
    mean = train_rows.mean(axis=0)
    std = train_rows.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    return ((feats - mean) / std).astype(np.float32)


def _build_neighbor_lists(n: int, edges: np.ndarray) -> list:
    out: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        out[a].append(b)
        out[b].append(a)
    return [np.asarray(x, dtype=np.int32) for x in out]
