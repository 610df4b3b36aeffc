"""Serving: a checkpoint -> class predictions for a node set
(``predict``), or -> every node's embedding (``export_embeddings``).

``predict`` loads a dataset in the reference file contract, builds the
full ("test") adjacency, restores a port checkpoint and sweeps the node
set in fixed-size batches on the device (the sweep and its helpers live
in ``train/supervised.py``, as in the JAX package). Ids are padded with
the dummy node N and masked out; the batches run in a Python loop whose
results land in preallocated device tensors, copied to the host once at
the end. It writes ``preds.npy`` ([n, C] sigmoid probabilities or softmax
distributions) and ``nodes.txt`` (original node ids), and reports loss
and micro/macro F1 when the dataset carries labels.

``predict --graph_shards N`` (with ``--data_shards M``: an M x N grid)
runs as one rank of a process group (``parallel/launch.py``): the
feature table and the full adjacency row-sharded over each graph group,
the sweep through the all-to-all exchange (``_prepare_sharded``,
``parallel/graph_sharded.py``), the ranks' rows reassembled in node
order; rank 0 writes the outputs. Checkpoints keep the identity table in
canonical id order, so any trainer's checkpoint serves under any shard
count.

``export_embeddings`` restores an unsupervised checkpoint and writes
``val.npy``/``val.txt`` through the trainer's own embed sweep and
sampler seed (``train/unsupervised.py``), so on the same device it
reproduces the trainer's export bit for bit. With ``--graph_shards N``
(and ``--data_shards M``) it runs as one rank, the tables sharded as
``predict``'s, through the sharded embed sweep; ``--data_shards``
alone runs on one device, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.models.supervised import init_supervised_params
from graphsage_tpu_torch.models.unsupervised import init_unsupervised_params
from graphsage_tpu_torch.parallel.distributed import host_array, make_grid
from graphsage_tpu_torch.parallel.graph_sharded import (
    local_shard,
    make_sharded_supervised_eval_sweep,
    reassemble_sharded_rows,
    suggest_capacity_factor,
)
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import (
    TrainFlags,
    feature_table,
    require_ported,
)
from graphsage_tpu_torch.train.metrics import calc_f1
from graphsage_tpu_torch.train.sharding import place_sharded_features
from graphsage_tpu_torch.train.supervised import (
    _run_eval_sweep,
    build_supervised_config,
    labels_table_of,
    make_eval_sweep,
)

NODE_SETS = ("test", "val", "train", "all")


def _prepare(flags: TrainFlags, graph, device):
    """Load the dataset and place the feature table and full adjacency."""
    if graph is None:
        graph = load_data(flags.train_prefix,
                          degree_relabel=flags.degree_relabel)
    # inference always sees the full graph (the reference's "test"
    # adjacency, swapped in for every eval)
    _, _, full_adj_np = build_both_adjs(
        graph, flags.max_degree, seed=flags.seed
    )
    features = feature_table(graph, flags, device)
    return graph, features, torch.from_numpy(full_adj_np).to(device)


def _restore_params(flags: TrainFlags, like: dict, device,
                    quiet: bool = False):
    """Restore trained params from flags.checkpoint_dir -> (params, step),
    checked key by key against the shapes of ``like``."""
    if not flags.checkpoint_dir:
        raise ValueError("inference requires --checkpoint_dir")
    restored = ckpt.restore(flags.checkpoint_dir, device=device)
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint found under {flags.checkpoint_dir!r}"
        )
    params, step = restored
    ckpt.check_matches(params, like)
    if flags.identity_dim > 0 and not quiet:
        print(
            "WARNING: identity_dim > 0 is transductive: the identity table "
            "is tied to the training graph's nodes."
        )
    return params, step


@dataclasses.dataclass
class _ShardedEnv:
    """A rank's grid, its shards of the placed tables and the restored
    params (``embeds`` its shard) for ``--graph_shards`` serving."""

    grid: object
    feat_local: object
    full_adj_local: torch.Tensor
    cap_factor: float
    params: dict
    step: int


def _prepare_sharded(flags: TrainFlags, graph, params_like: dict,
                     device) -> _ShardedEnv:
    D, Dd = flags.graph_shards, max(flags.data_shards, 1)
    if flags.batch_size % (D * Dd):
        raise ValueError("batch_size must divide data_shards * graph_shards")
    grid = make_grid(D, Dd)
    layout = flags.shard_layout
    _, _, full_adj_np = build_both_adjs(
        graph, flags.max_degree, seed=flags.seed
    )
    feat_local = place_sharded_features(
        graph, D, grid.graph_rank, flags.feature_dtype, layout, device)
    full_adj = torch.from_numpy(
        local_shard(full_adj_np, D, grid.graph_rank, layout)).to(device)
    cap_factor = flags.capacity_factor or suggest_capacity_factor(
        full_adj_np, D, layout=layout)
    params, step = _restore_params(flags, params_like, device,
                                   quiet=not grid.is_chief)
    if "embeds" in params:
        params["embeds"] = torch.from_numpy(local_shard(
            params["embeds"].cpu().numpy(), D, grid.graph_rank, layout)).to(
                device)
    return _ShardedEnv(grid=grid, feat_local=feat_local,
                       full_adj_local=full_adj, cap_factor=cap_factor,
                       params=params, step=step)


def _warn_dropped(dropped, cap_factor: float, where: str) -> None:
    d = int(dropped)
    if d > 0:
        print(f"WARNING: {where}: {d} gather requests overflowed the "
              f"all-to-all capacity and returned ZERO rows "
              f"(capacity_factor={cap_factor:.2f}). "
              f"Raise --capacity_factor.")


def _sharded_sweep(flags: TrainFlags, graph, config, node_idx, labels_np,
                   device):
    """(loss, preds, labels, seconds, step, chief) of the sharded sweep
    over ``node_idx``, the preds in node order on every rank."""
    env = _prepare_sharded(
        flags, graph, init_supervised_params(torch.Generator(), config),
        device)
    B, N = flags.batch_size, graph.num_nodes
    sweep = make_sharded_supervised_eval_sweep(
        config, env.grid, B, capacity_factor=env.cap_factor)
    t0 = time.perf_counter()
    n_b = max(1, -(-len(node_idx) // B))
    ids_all = np.full((n_b * B,), N, dtype=np.int32)
    ids_all[: len(node_idx)] = node_idx
    losses, preds, dropped = sweep(
        env.params, env.feat_local, env.full_adj_local,
        torch.from_numpy(ids_all).to(device),
        torch.from_numpy(labels_table_of(labels_np, N)).to(device),
        torch.Generator(device=device).manual_seed(flags.seed + 1))
    if env.grid.is_chief:
        _warn_dropped(dropped, env.cap_factor, "eval sweep")
    preds = reassemble_sharded_rows(host_array(preds), env.grid.total,
                                    n_b)[: len(node_idx)]
    loss = float(np.mean(losses.cpu().numpy()))
    return (loss, preds, labels_np[node_idx], time.perf_counter() - t0,
            env.step, env.grid.is_chief)


def _select_nodes(graph, nodes: str) -> np.ndarray:
    if nodes == "all":
        return np.arange(graph.num_nodes)
    mask = {
        "train": graph.is_train, "val": graph.is_val, "test": graph.is_test,
    }[nodes]
    return np.flatnonzero(mask)


def predict(flags: TrainFlags, out_dir: str | None = None,
            nodes: str = "test", num_classes: int = 0, graph=None,
            device="cuda") -> dict:
    """Checkpoint -> class predictions for a node set, written as
    preds.npy + nodes.txt under ``out_dir``.

    Runs on ``device`` (``cuda`` unless the caller asks for ``cpu``).
    An unlabeled dataset (no class_map) needs ``num_classes`` from the
    training run. With ``--graph_shards`` above 1 this process is one
    rank of an initialised process group; rank 0 writes.
    """
    require_ported(flags)
    device = resolve_device(device)
    if nodes not in NODE_SETS:
        raise ValueError(f"nodes must be one of {NODE_SETS}")
    sharded = flags.graph_shards > 1
    if not sharded:
        graph, features, full_adj = _prepare(flags, graph, device)
    elif graph is None:
        graph = load_data(flags.train_prefix,
                          load_features=not flags.defer_features,
                          degree_relabel=flags.degree_relabel)
    if graph.num_classes is None:
        if num_classes <= 0:
            raise ValueError(
                "dataset has no class_map; pass the training run's "
                "--num_classes"
            )
        graph = dataclasses.replace(graph, num_classes=num_classes)
    config = build_supervised_config(flags, graph)

    node_idx = _select_nodes(graph, nodes)
    if len(node_idx) == 0:
        raise ValueError(f"node set {nodes!r} is empty in this dataset")
    labels_np = graph.labels
    have_labels = labels_np is not None
    if not have_labels:
        labels_np = np.zeros(
            (graph.num_nodes, graph.num_classes), dtype=np.float32
        )
    if sharded:
        loss, preds, labels, dt, step, chief = _sharded_sweep(
            flags, graph, config, node_idx, labels_np, device)
    else:
        params, step = _restore_params(
            flags, init_supervised_params(torch.Generator(), config), device)
        sweep = make_eval_sweep(config, flags.batch_size, graph.num_nodes)
        generator = torch.Generator(device=device).manual_seed(flags.seed + 1)
        loss, preds, labels, dt = _run_eval_sweep(
            sweep, params, features, full_adj, node_idx, labels_np,
            flags.batch_size, graph.num_nodes, generator,
        )
        chief = True
    if not chief:
        return {"n": len(node_idx), "step": step, "device": str(device)}

    out_dir = out_dir or flags.log_dir("supervised")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "preds.npy"), preds)
    with open(os.path.join(out_dir, "nodes.txt"), "w") as fp:
        fp.write("\n".join(str(graph.node_ids[i]) for i in node_idx))
    result = {
        "out_dir": out_dir, "nodes": nodes, "n": len(node_idx),
        "step": step, "time": dt, "device": str(device),
    }
    msg = (f"Predicted {len(node_idx)} {nodes} nodes "
           f"(checkpoint step {step}) on {device} -> {out_dir}")
    if have_labels:
        f1_mic, f1_mac = calc_f1(labels, preds, flags.sigmoid)
        result.update(loss=loss, f1_micro=f1_mic, f1_macro=f1_mac)
        msg += (f"  loss={loss:.5f} f1_micro={f1_mic:.5f} "
                f"f1_macro={f1_mac:.5f}")
    print(msg)
    return result


def export_embeddings(flags: TrainFlags, out_dir: str | None = None,
                      graph=None, device="cuda") -> str | None:
    """Checkpoint -> the l2-normalised embedding of every node, written
    as val.npy + val.txt (the trainer's export) under ``out_dir``; runs
    on ``device`` (``cuda`` unless the caller asks for ``cpu``). With
    ``--graph_shards`` above 1 this process is one rank of an
    initialised process group and rank 0 writes (the others return
    None); the sweep and its sampler seed (``seed + 2``) are the sharded
    trainer's, so a sharded run's ``val.npy`` comes back bit for bit."""
    from graphsage_tpu_torch.train.unsupervised import (
        build_unsupervised_config,
        embed_all_nodes,
        sharded_embed_all_nodes,
        write_embeddings,
    )

    if flags.model == "n2v":
        raise ValueError(
            "n2v is embedding-table-only (transductive); its embeddings "
            "are exported by the trainer itself (val.npy / val-test.npy)")
    require_ported(flags)
    device = resolve_device(device)
    if flags.graph_shards > 1:
        if graph is None:
            graph = load_data(flags.train_prefix,
                              load_features=not flags.defer_features,
                              degree_relabel=flags.degree_relabel)
        config = build_unsupervised_config(flags, graph)
        env = _prepare_sharded(flags, graph, init_unsupervised_params(
            torch.Generator(), config), device)
        rows, dropped = sharded_embed_all_nodes(
            config, env.grid, flags.batch_size, env.params, env.feat_local,
            env.full_adj_local, flags.seed + 2, env.cap_factor)
        step = env.step
        if not env.grid.is_chief:
            return None
        _warn_dropped(dropped, env.cap_factor, "embedding export")
    else:
        graph, features, full_adj = _prepare(flags, graph, device)
        config = build_unsupervised_config(flags, graph)
        params, step = _restore_params(
            flags, init_unsupervised_params(torch.Generator(), config),
            device)
        # the trainer's sampler seed for its export
        rows = embed_all_nodes(config, flags.batch_size, params, features,
                               full_adj, flags.seed + 1)
    out_dir = out_dir or flags.log_dir("unsupervised")
    write_embeddings(out_dir, rows, graph.node_ids)
    print(f"Wrote {rows.shape[0]} x {rows.shape[1]} embeddings "
          f"(checkpoint step {step}) on {device} to {out_dir}")
    return out_dir
