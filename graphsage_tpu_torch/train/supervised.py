"""Supervised training on one device, and the evaluation helpers that
serving shares.

``train`` follows the JAX package's single-device loop: the padded
train-id array and the label table live on the device; each epoch's
permutation is drawn on the host, from a NumPy generator seeded by
``--seed``, and copied to the device once; the chunk runner
(``parallel/dp.py``) runs up to ``min(print_every, validate_iter)``
steps between host synchronisations. Validation crosses
``validate_iter`` on the full adjacency (a sampled batch, or the whole
val set with ``validate_batch_size == -1``), training runs on the train
adjacency, and the print line and ``val_stats.txt``/``test_stats.txt``
have the JAX package's format.

Options shared with ``train/unsupervised.py``: ``--profile_dir`` traces
the training loop with ``torch.profiler`` into a Chrome trace there
(``train/tblog.py::TrainingProfile``); ``--log_histograms`` logs every
parameter's and a probe batch's per-layer activations' histograms at
each print step (``tblog.histogram_probe``,
``ScalarLogger.log_histograms``).

Multi-device runs (one process per device, ``parallel/launch.py``) go
through the same loop with other pieces (``_Pieces``): ``--data_shards
M`` alone swaps in the data-parallel chunk runner (``parallel/dp.py``),
every rank holding the whole tables (``_replicated_pieces``);
``--graph_shards N`` (with ``--data_shards M``: an M x N grid) the
tables row-sharded across each graph group, with the sharded runner,
evaluations and checkpoint transforms (``_sharded_pieces``,
``parallel/graph_sharded.py``); ``--n_model_shards M`` (with
``--data_shards D``: a D x M grid) the feature and identity tables split
on their columns and layer 0's contracting weights on their rows over
each model group, with the tensor-parallel runner, evaluations and
checkpoint transforms (``_tensor_pieces``, ``parallel/tensor.py``).
Rank 0 prints and writes the logs, stats and checkpoints; a checkpoint
keeps the identity table in canonical id order and every model shard
whole, so a run resumes under any shard count or layout, or on one
device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data, materialize_features
from graphsage_tpu_torch.data.minibatch import NodeBatcher
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.models.graphsage import SAGEConfig
from graphsage_tpu_torch.models.supervised import (
    SupervisedConfig,
    init_supervised_params,
    make_optimizer,
    supervised_loss,
    supervised_predict,
)
from graphsage_tpu_torch.parallel.distributed import (
    fold_seed,
    host_array,
    make_grid,
)
from graphsage_tpu_torch.parallel.dp import (
    make_dp_supervised_chunk_runner,
    make_supervised_chunk_runner,
    make_tp_supervised_chunk_runner,
)
from graphsage_tpu_torch.parallel.graph_sharded import (
    local_shard,
    make_sharded_supervised_chunk_runner,
    make_sharded_supervised_eval,
    make_sharded_supervised_eval_sweep,
    reassemble_sharded_rows,
    suggest_capacity_factor,
)
from graphsage_tpu_torch.parallel.tensor import ModelShard, tp_seed
from graphsage_tpu_torch.trace import span
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import (
    TrainFlags,
    build_layer_infos,
    check_model_shards,
    feature_table,
)
from graphsage_tpu_torch.train.metrics import calc_f1
from graphsage_tpu_torch.train.sharding import (
    DroppedRequests,
    canonical_state,
    local_state,
    model_local_state,
    model_shard_params,
    model_whole_state,
    place_column_block,
    place_sharded_features,
    quiet,
    restore,
    sharded_params,
)
from graphsage_tpu_torch.train.tblog import (
    ScalarLogger,
    TrainingProfile,
    histogram_probe,
)


def build_supervised_config(flags: TrainFlags, graph) -> SupervisedConfig:
    agg, concat, layers = build_layer_infos(flags, supervised=True)
    if graph.feature_dim == 0 and flags.identity_dim == 0:
        raise ValueError(
            "Must have a positive value for identity feature dimension if no "
            "input features given."
        )
    sage = SAGEConfig(
        layers=layers,
        feature_dim=graph.feature_dim,
        aggregator=agg,
        concat=concat,
        model_size=flags.model_size,
        identity_dim=flags.identity_dim,
        num_nodes=graph.num_nodes,
        dropout=flags.dropout,
        sampler_mode=flags.sampler_mode,
        fused_gather=flags.fused_gather,
        dedup_gather=flags.dedup_gather,
        rows_gather=flags.rows_gather,
        shard_layout=flags.shard_layout,
    )
    return SupervisedConfig(
        sage=sage,
        num_classes=graph.num_classes,
        sigmoid_loss=flags.sigmoid,
        weight_decay=flags.weight_decay,
    )


def make_eval_step(config: SupervisedConfig, shard=None):
    """eval_step(params, features, adj, ids, labels, mask, generator) ->
    (loss, preds) on one batch, no dropout, results on the device. Under
    tensor parallelism (``shard``) every rank of the model group
    evaluates the whole batch on its blocks, and gets the whole result."""

    @torch.inference_mode()
    def eval_step(params, features, adj, ids, labels, mask, generator=None):
        with span("eval.step"):
            loss, logits = supervised_loss(
                params, features, adj, ids, labels, mask, config,
                generator=generator, deterministic=True, shard=shard,
            )
            with span("head"):
                return loss, supervised_predict(logits, config)

    return eval_step


def make_eval_sweep(config: SupervisedConfig, batch_size: int,
                    num_nodes: int, shard=None):
    """sweep(params, features, adj, ids_all, labels_table, generator) ->
    (per-batch losses [n_b], flat preds [n_b*B, C]), both on the device.

    ``ids_all`` is a dummy-padded id stream of n_b*B ids and
    ``labels_table`` has N+1 rows (the dummy's row is never scored: the
    mask is ``ids != N``). Nothing is copied to the host. ``shard``: as
    ``make_eval_step``'s.
    """
    eval_step = make_eval_step(config, shard)

    @torch.inference_mode()
    def sweep(params, features, adj, ids_all, labels_table, generator=None):
        with span("eval.sweep"):
            n_b = ids_all.shape[0] // batch_size
            device = ids_all.device
            losses = torch.zeros(n_b, device=device)
            preds = torch.zeros(n_b * batch_size, config.num_classes,
                                device=device)
            for i in range(n_b):
                ids = ids_all[i * batch_size:(i + 1) * batch_size]
                labels = labels_table.index_select(0, ids)
                mask = (ids != num_nodes).float()
                losses[i], preds[i * batch_size:(i + 1) * batch_size] = (
                    eval_step(params, features, adj, ids, labels, mask,
                              generator))
            return losses, preds

    return sweep


def labels_table_of(labels_np: np.ndarray, num_nodes: int) -> np.ndarray:
    """[N+1, C] float32 labels; the dummy's row is zeros."""
    table = np.zeros((num_nodes + 1, labels_np.shape[1]), dtype=np.float32)
    table[: labels_np.shape[0]] = labels_np
    return table


def _run_eval_sweep(sweep_fn, params, features, adj, nodes, labels_np,
                    batch_size: int, num_nodes: int, generator=None):
    """Pad ``nodes`` into batches, run the sweep on ``adj``'s device and
    copy the results to the host once -> (mean loss, preds [n, C],
    labels [n, C], seconds)."""
    t0 = time.perf_counter()
    device = adj.device
    n_b = max(1, -(-len(nodes) // batch_size))
    ids_all = np.full((n_b * batch_size,), num_nodes, dtype=np.int32)
    ids_all[: len(nodes)] = nodes
    losses, preds = sweep_fn(
        params, features, adj, torch.from_numpy(ids_all).to(device),
        torch.from_numpy(labels_table_of(labels_np, num_nodes)).to(device),
        generator,
    )
    host = torch.cat([losses, preds.reshape(-1)]).cpu().numpy()
    loss = float(np.mean(host[:n_b]))
    preds = host[n_b:].reshape(n_b * batch_size, -1)[: len(nodes)]
    return loss, preds, labels_np[nodes], time.perf_counter() - t0


def _write_stats(path: str, loss, f1_mic, f1_mac, duration=None) -> None:
    line = "loss={:.5f} f1_micro={:.5f} f1_macro={:.5f}".format(
        loss, f1_mic, f1_mac)
    if duration is not None:
        line += " time={:.5f}".format(duration)
    with open(path, "w") as fp:
        fp.write(line)


def train(flags: TrainFlags, graph=None, device="cuda") -> dict:
    """Train on ``device`` (``cuda`` unless the caller asks for ``cpu``);
    returns the params and the final val/test metrics. With
    ``--graph_shards``, ``--data_shards`` or ``--n_model_shards`` above
    1 this process is one rank of an initialised process group
    (``parallel/launch.py``), on its own device; the metrics are rank
    0's."""
    check_model_shards(flags)
    device = resolve_device(device)
    sharded = flags.graph_shards > 1
    tp = flags.n_model_shards > 1
    if tp:
        grid = make_grid(1, flags.data_shards, flags.n_model_shards)
    else:
        grid = (make_grid(flags.graph_shards, flags.data_shards)
                if sharded or flags.data_shards > 1 else None)
    chief = grid is None or grid.is_chief
    say = print if chief else quiet
    if graph is None:
        say("Loading training data..")
        graph = load_data(flags.train_prefix,
                          load_features=not flags.defer_features,
                          degree_relabel=flags.degree_relabel)
        say("Done loading training data..")
    if not sharded:   # whole tables: a deferred table is read whole now
        graph = materialize_features(graph)
    config = build_supervised_config(flags, graph)
    sigmoid = flags.sigmoid

    train_adj_np, deg, full_adj_np = build_both_adjs(
        graph, flags.max_degree, seed=flags.seed
    )
    batcher = NodeBatcher(graph, deg, flags.batch_size, seed=flags.seed)
    B = flags.batch_size
    dummy = graph.num_nodes
    labels_table = labels_table_of(graph.labels, dummy)
    labels_table_dev = torch.from_numpy(labels_table).to(device)
    optimizer = make_optimizer(flags.learning_rate)
    make_pieces = (_sharded_pieces if sharded else
                   _tensor_pieces if tp else _replicated_pieces)
    pc = make_pieces(flags, graph, config, optimizer, grid, train_adj_np,
                     full_adj_np, labels_table_dev, device, say)
    params = pc.params
    opt_state = optimizer.init(params)
    drops = DroppedRequests(pc.capacity_factor, say)

    def eval_generator():
        # the same on every rank, as the JAX package's eval key, so a
        # sharded sweep samples as the single-device sweep does
        return torch.Generator(device=device).manual_seed(flags.seed + 1)

    def full_eval(nodes):
        t0 = time.perf_counter()
        loss, preds, dropped = pc.sweep(params, nodes, eval_generator())
        drops.note(dropped, "eval sweep")
        return loss, preds, graph.labels[nodes], time.perf_counter() - t0

    def save(step):
        saved, saved_opt = pc.to_saved(
            params, optimizer.state_dict(opt_state, params))
        if chief:
            ckpt.save(flags.checkpoint_dir, saved, step, saved_opt)

    total_steps = 0
    if flags.checkpoint_dir and flags.resume:
        total_steps = restore(flags, params, optimizer, opt_state,
                              pc.saved_like, pc.to_local, device, say)

    # rank 0 logs; it evaluates alone unless the tables are sharded
    evaluates = chief or pc.collective
    log_dir = flags.log_dir("supervised") if chief else None
    logger = ScalarLogger(log_dir) if chief else None
    probe = (histogram_probe(config.sage, graph, B, flags.seed + 1, device)
             if flags.log_histograms and chief and not pc.collective
             else None)
    if grid is None:
        sampler_seed = flags.seed
    else:
        sampler_seed = (tp_seed(flags.seed, grid) if tp
                        else fold_seed(flags.seed, grid.me))
    sampler_generator = torch.Generator(device=device).manual_seed(
        sampler_seed)
    host_rng = np.random.default_rng(flags.seed)
    avg_time = 0.0
    timed_steps = 0   # steps timed in this process (not resumed ones)
    val_cost = val_f1_mic = val_f1_mac = 0.0
    stop = False
    # overflow drops add up on the device; the host reads them at prints
    pending_dropped = 0
    profiler = (TrainingProfile(flags.profile_dir, device)
                if flags.profile_dir and chief else None)

    steps_per_epoch = max(1, batcher.num_batches())
    ids_padded = np.full((steps_per_epoch * B,), dummy, dtype=np.int32)
    ids_padded[: len(batcher.train_nodes)] = batcher.train_nodes
    chunk = max(1, min(flags.print_every, flags.validate_iter))
    for epoch in range(flags.epochs):
        say("Epoch: %04d" % (epoch + 1))
        ids_perm = torch.from_numpy(
            ids_padded[host_rng.permutation(len(ids_padded))]
        ).to(device)
        drop_seed = int(host_rng.integers(0, 2**63))
        it = 0
        while it < steps_per_epoch:
            n = min(chunk, steps_per_epoch - it,
                    max(1, flags.max_total_steps + 1 - total_steps))
            t = time.time()
            out = pc.run_chunk(
                params, opt_state, sampler_generator, pc.features,
                pc.train_adj, ids_perm, labels_table_dev, it, n,
                drop_seed=drop_seed,
            )
            params, opt_state, loss, logits, last_ids = out[:5]
            if sharded:
                pending_dropped = pending_dropped + out[5]

            # validate when [it, it+n) crosses a multiple of validate_iter
            if evaluates and (it + n - 1) % flags.validate_iter < n:
                if flags.validate_batch_size == -1:
                    val_cost, vp, vl, _ = full_eval(batcher.val_nodes)
                    val_f1_mic, val_f1_mac = calc_f1(vl, vp, sigmoid)
                else:
                    vbs = flags.validate_batch_size
                    if sharded:   # as the JAX package's sharded trainer
                        vbs = max(vbs, 1)
                    # a sharded eval splits the batch over the graph
                    # group: padded to a multiple of it (zero mask)
                    vb = batcher.sample_val_batch(
                        vbs, pad_to=-(-vbs // pc.val_multiple)
                        * pc.val_multiple)
                    val_cost, vpred, vdropped = pc.eval_batch(
                        params, vb, eval_generator())
                    drops.note(vdropped, "validation")
                    k = int(vb.mask.sum())
                    val_f1_mic, val_f1_mac = calc_f1(
                        vb.labels[:k], vpred[:k], sigmoid
                    )

            it += n
            total_steps += n
            timed_steps += n
            avg_time = (
                avg_time * (timed_steps - n) + time.time() - t
            ) / timed_steps

            if (total_steps - 1) % flags.print_every < n:
                if sharded:
                    drops.note(pending_dropped, "train chunks")
                    pending_dropped = 0
                ids_np = pc.rows(last_ids)   # every rank's rows
                preds = pc.rows(supervised_predict(logits, config))
                keep = ids_np != dummy
                f1_mic, f1_mac = calc_f1(
                    labels_table[ids_np[keep]], preds[keep], sigmoid
                )
                train_loss = float(loss)
                say(
                    "Iter:", "%04d" % (it - 1),
                    "train_loss=", "{:.5f}".format(train_loss),
                    "train_f1_mic=", "{:.5f}".format(f1_mic),
                    "train_f1_mac=", "{:.5f}".format(f1_mac),
                    "val_loss=", "{:.5f}".format(val_cost),
                    "val_f1_mic=", "{:.5f}".format(val_f1_mic),
                    "val_f1_mac=", "{:.5f}".format(val_f1_mac),
                    "time=", "{:.5f}".format(avg_time),
                )
                if chief:
                    logger.log(
                        total_steps - 1, train_loss=train_loss,
                        train_f1_mic=f1_mic, train_f1_mac=f1_mac,
                        val_loss=val_cost, val_f1_mic=val_f1_mic,
                        val_f1_mac=val_f1_mac, step_time=avg_time,
                    )
                    if flags.log_histograms:
                        logger.log_histograms(total_steps - 1, params)
                if probe is not None:
                    logger.log_histograms(
                        total_steps - 1,
                        probe(params, pc.features, pc.train_adj), prefix="")

            if (evaluates and flags.checkpoint_dir and flags.checkpoint_every
                    and total_steps % flags.checkpoint_every < n):
                save(total_steps)
            if total_steps > flags.max_total_steps:
                stop = True
                break
        if stop:
            break
    if profiler is not None:
        profiler.stop()
    if sharded:
        drops.note(pending_dropped, "train chunks")

    say("Optimization Finished!")
    if not evaluates:
        return {"params": params, "steps": total_steps, "log_dir": None}
    val_cost, vp, vl, duration = full_eval(batcher.val_nodes)
    val_f1_mic, val_f1_mac = calc_f1(vl, vp, sigmoid)
    say(
        "Full validation stats:",
        "loss=", "{:.5f}".format(val_cost),
        "f1_micro=", "{:.5f}".format(val_f1_mic),
        "f1_macro=", "{:.5f}".format(val_f1_mac),
        "time=", "{:.5f}".format(duration),
    )
    say("Writing test set stats to file (don't peak!)")
    test_cost, tp, tl, _ = full_eval(batcher.test_nodes)
    test_f1_mic, test_f1_mac = calc_f1(tl, tp, sigmoid)
    if flags.checkpoint_dir:
        save(total_steps)
    if chief:
        _write_stats(log_dir + "/val_stats.txt", val_cost, val_f1_mic,
                     val_f1_mac, duration)
        _write_stats(log_dir + "/test_stats.txt", test_cost, test_f1_mic,
                     test_f1_mac)
        logger.log(total_steps, final_val_loss=val_cost,
                   final_val_f1_mic=val_f1_mic, final_val_f1_mac=val_f1_mac)
        logger.close()

    return {
        "params": params,
        "val_loss": val_cost,
        "val_f1_mic": val_f1_mic,
        "val_f1_mac": val_f1_mac,
        "test_f1_mic": test_f1_mic,
        "test_f1_mac": test_f1_mac,
        "steps": total_steps,
        "log_dir": log_dir,
        "dropped": drops.total,
    }


# ------------------------------------------------- the trainer's modes

@dataclasses.dataclass
class _Pieces:
    """What a mode hands ``train``'s loop: this rank's tables and params,
    the chunk runner, and the evaluation and checkpoint functions, which
    return host values.

    - ``run_chunk``: the runners' call; its first five outputs are
      (params, opt_state, last_loss, last_logits, last_ids), a sharded
      runner's sixth the chunk's dropped count;
    - ``eval_batch(params, vb, generator)`` -> (loss, preds [b, C],
      dropped) of a sampled val batch (``vb`` padded to a multiple of
      ``val_multiple``); ``sweep(params, nodes, generator)`` -> (mean
      loss, preds [n, C], dropped) over ``nodes``;
    - ``rows(t)``: every rank's rows of a batch-split tensor, stacked;
    - ``to_saved(params, opt_state_dict)`` and ``to_local(tree)``: a
      checkpoint's whole, canonical state from this rank's and back
      (``saved_like`` gives the checkpoint's shapes);
    - ``collective``: every rank takes part in the evaluations and the
      saves (the tables are sharded, or split on their columns); else
      rank 0 runs them alone.
    """

    features: object
    train_adj: torch.Tensor
    params: dict
    run_chunk: object
    eval_batch: object
    sweep: object
    rows: object
    to_saved: object
    to_local: object
    saved_like: dict
    collective: bool
    val_multiple: int = 1
    capacity_factor: float = 0.0


def _replicated_pieces(flags, graph, config, optimizer, grid, train_adj_np,
                       full_adj_np, labels_table_dev, device, say):
    """One device, or ``--data_shards M`` alone (``grid``): every rank
    holds the whole tables and params."""
    B, dummy = flags.batch_size, graph.num_nodes
    features = feature_table(graph, flags, device)
    full_adj = torch.from_numpy(full_adj_np).to(device)
    params = init_supervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    )
    if grid is None:
        run_chunk = make_supervised_chunk_runner(config, optimizer, B)
    else:
        run_chunk = make_dp_supervised_chunk_runner(config, optimizer, grid,
                                                    B)
    eval_step = make_eval_step(config)
    eval_sweep = make_eval_sweep(config, B, dummy)

    def eval_batch(params, vb, generator):
        loss, preds = eval_step(
            params, features, full_adj, torch.from_numpy(vb.ids).to(device),
            torch.from_numpy(vb.labels).to(device),
            torch.from_numpy(vb.mask).to(device), generator)
        return float(loss), preds.cpu().numpy(), 0

    def sweep(params, nodes, generator):
        loss, preds, _, _ = _run_eval_sweep(
            eval_sweep, params, features, full_adj, nodes, graph.labels, B,
            dummy, generator)
        return loss, preds, 0

    return _Pieces(
        features=features,
        train_adj=torch.from_numpy(train_adj_np).to(device), params=params,
        run_chunk=run_chunk, eval_batch=eval_batch, sweep=sweep,
        rows=((lambda t: t.cpu().numpy()) if grid is None else host_array),
        to_saved=lambda params, opt: (params, opt),
        to_local=lambda tree: tree, saved_like=params, collective=False)


def _sharded_pieces(flags, graph, config, optimizer, grid, train_adj_np,
                    full_adj_np, labels_table_dev, device, say):
    """--graph_shards N (x --data_shards M): the feature, adjacency and
    identity tables row-sharded over each graph group, every frontier
    gather through the all-to-all exchange, each batch split over the
    whole grid (``parallel/graph_sharded.py``)."""
    D, g, layout = grid.graph_size, grid.graph_rank, flags.shard_layout
    B, dummy = flags.batch_size, graph.num_nodes
    n_rows = graph.num_nodes + 1
    feat_local = place_sharded_features(graph, D, g, flags.feature_dtype,
                                        layout, device)
    full_adj = torch.from_numpy(
        local_shard(full_adj_np, D, g, layout)).to(device)
    cap_factor = flags.capacity_factor or suggest_capacity_factor(
        full_adj_np, D, layout=layout)
    say(f"graph_shards={D} layout={layout} "
        f"capacity_factor={cap_factor:.2f}"
        + (" (auto)" if not flags.capacity_factor else ""))
    params, saved_like = sharded_params(init_supervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    ), grid, layout)
    eval_step = make_sharded_supervised_eval(config, grid,
                                             capacity_factor=cap_factor)
    eval_sweep = make_sharded_supervised_eval_sweep(
        config, grid, B, capacity_factor=cap_factor)

    def eval_batch(params, vb, generator):
        loss, preds, dropped = eval_step(
            params, feat_local, full_adj, torch.from_numpy(vb.ids).to(device),
            torch.from_numpy(vb.labels).to(device),
            torch.from_numpy(vb.mask).to(device), generator)
        return float(loss), host_array(preds, grid.graph_group), dropped

    def sweep(params, nodes, generator):
        n_b = max(1, -(-len(nodes) // B))
        ids_all = np.full((n_b * B,), dummy, dtype=np.int32)
        ids_all[: len(nodes)] = nodes
        losses, preds, dropped = eval_sweep(
            params, feat_local, full_adj,
            torch.from_numpy(ids_all).to(device), labels_table_dev,
            generator)
        preds = reassemble_sharded_rows(host_array(preds), grid.total,
                                        n_b)[: len(nodes)]
        return float(np.mean(losses.cpu().numpy())), preds, dropped

    return _Pieces(
        features=feat_local,
        train_adj=torch.from_numpy(
            local_shard(train_adj_np, D, g, layout)).to(device),
        params=params,
        run_chunk=make_sharded_supervised_chunk_runner(
            config, optimizer, grid, B, capacity_factor=cap_factor),
        eval_batch=eval_batch, sweep=sweep, rows=host_array,
        to_saved=lambda params, opt: canonical_state(
            params, opt, grid, layout, n_rows),
        to_local=lambda tree: local_state(tree, grid, layout),
        saved_like=saved_like, collective=True, val_multiple=D,
        capacity_factor=cap_factor)


def _tensor_pieces(flags, graph, config, optimizer, grid, train_adj_np,
                   full_adj_np, labels_table_dev, device, say):
    """--n_model_shards M (x --data_shards D): each rank holds its model
    shard's column blocks of the feature and identity tables and the
    matching rows of layer 0's contracting weights, the rest whole
    (``parallel/tensor.py``); each step's batch splits over the data
    slices, and every rank evaluates the whole val batch or sweep, as
    the JAX package's GSPMD sweep does."""
    B, dummy = flags.batch_size, graph.num_nodes
    shard = ModelShard.of(config.sage, grid)
    lo, hi = shard.feat_block
    say(f"n_model_shards={grid.model_size} data_shards={grid.data_size}: "
        f"feature columns {lo}..{hi - 1} of {config.sage.feature_dim} on "
        f"rank 0")
    features = place_column_block(graph, flags.feature_dtype, shard, device)
    full_adj = torch.from_numpy(full_adj_np).to(device)
    params, saved_like = model_shard_params(init_supervised_params(
        torch.Generator().manual_seed(flags.seed), config), shard, device)
    eval_step = make_eval_step(config, shard)
    eval_sweep = make_eval_sweep(config, B, dummy, shard)

    def eval_batch(params, vb, generator):
        loss, preds = eval_step(
            params, features, full_adj, torch.from_numpy(vb.ids).to(device),
            torch.from_numpy(vb.labels).to(device),
            torch.from_numpy(vb.mask).to(device), generator)
        return float(loss), preds.cpu().numpy(), 0

    def sweep(params, nodes, generator):
        loss, preds, _, _ = _run_eval_sweep(
            eval_sweep, params, features, full_adj, nodes, graph.labels, B,
            dummy, generator)
        return loss, preds, 0

    return _Pieces(
        features=features,
        train_adj=torch.from_numpy(train_adj_np).to(device), params=params,
        run_chunk=make_tp_supervised_chunk_runner(config, optimizer, grid,
                                                  B),
        eval_batch=eval_batch, sweep=sweep,
        rows=lambda t: host_array(t, grid.data_group),
        to_saved=lambda params, opt: model_whole_state(params, opt, shard),
        to_local=lambda tree: model_local_state(tree, shard),
        saved_like=saved_like, collective=True)
