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
"""

from __future__ import annotations

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
from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import (
    TrainFlags,
    build_layer_infos,
    feature_table,
    require_ported,
)
from graphsage_tpu_torch.train.metrics import calc_f1
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
    )
    return SupervisedConfig(
        sage=sage,
        num_classes=graph.num_classes,
        sigmoid_loss=flags.sigmoid,
        weight_decay=flags.weight_decay,
    )


def make_eval_step(config: SupervisedConfig):
    """eval_step(params, features, adj, ids, labels, mask, generator) ->
    (loss, preds) on one batch, no dropout, results on the device."""

    @torch.inference_mode()
    def eval_step(params, features, adj, ids, labels, mask, generator=None):
        loss, logits = supervised_loss(
            params, features, adj, ids, labels, mask, config,
            generator=generator, deterministic=True,
        )
        return loss, supervised_predict(logits, config)

    return eval_step


def make_eval_sweep(config: SupervisedConfig, batch_size: int,
                    num_nodes: int):
    """sweep(params, features, adj, ids_all, labels_table, generator) ->
    (per-batch losses [n_b], flat preds [n_b*B, C]), both on the device.

    ``ids_all`` is a dummy-padded id stream of n_b*B ids and
    ``labels_table`` has N+1 rows (the dummy's row is never scored: the
    mask is ``ids != N``). Nothing is copied to the host.
    """
    eval_step = make_eval_step(config)

    @torch.inference_mode()
    def sweep(params, features, adj, ids_all, labels_table, generator=None):
        n_b = ids_all.shape[0] // batch_size
        device = ids_all.device
        losses = torch.zeros(n_b, device=device)
        preds = torch.zeros(n_b * batch_size, config.num_classes,
                            device=device)
        for i in range(n_b):
            ids = ids_all[i * batch_size:(i + 1) * batch_size]
            labels = labels_table.index_select(0, ids)
            mask = (ids != num_nodes).float()
            losses[i], preds[i * batch_size:(i + 1) * batch_size] = eval_step(
                params, features, adj, ids, labels, mask, generator)
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
    returns the params and the final val/test metrics."""
    require_ported(flags)
    device = resolve_device(device)
    if graph is None:
        print("Loading training data..")
        graph = load_data(flags.train_prefix,
                          load_features=not flags.defer_features,
                          degree_relabel=flags.degree_relabel)
        print("Done loading training data..")
    # one device: a deferred table is read whole now
    graph = materialize_features(graph)
    config = build_supervised_config(flags, graph)
    sigmoid = flags.sigmoid

    train_adj_np, deg, full_adj_np = build_both_adjs(
        graph, flags.max_degree, seed=flags.seed
    )
    batcher = NodeBatcher(graph, deg, flags.batch_size, seed=flags.seed)
    features = feature_table(graph, flags, device)
    train_adj = torch.from_numpy(train_adj_np).to(device)
    full_adj = torch.from_numpy(full_adj_np).to(device)

    params = init_supervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    )
    optimizer = make_optimizer(flags.learning_rate)
    opt_state = optimizer.init(params)

    B = flags.batch_size
    dummy = graph.num_nodes
    steps_per_epoch = max(1, batcher.num_batches())
    ids_padded = np.full((steps_per_epoch * B,), dummy, dtype=np.int32)
    ids_padded[: len(batcher.train_nodes)] = batcher.train_nodes
    labels_table = labels_table_of(graph.labels, dummy)
    labels_table_dev = torch.from_numpy(labels_table).to(device)

    run_chunk = make_supervised_chunk_runner(config, optimizer, B)
    eval_step = make_eval_step(config)
    eval_sweep = make_eval_sweep(config, B, dummy)

    def eval_generator():
        return torch.Generator(device=device).manual_seed(flags.seed + 1)

    def full_eval(nodes):
        return _run_eval_sweep(
            eval_sweep, params, features, full_adj, nodes, graph.labels,
            B, dummy, eval_generator(),
        )

    total_steps = 0
    if flags.checkpoint_dir and flags.resume:
        restored = ckpt.restore_train_state(flags.checkpoint_dir, device)
        if restored is not None:
            saved, saved_opt, total_steps = restored
            ckpt.check_matches(saved, params)
            with torch.no_grad():
                for k, v in saved.items():
                    params[k].copy_(v)
            if saved_opt is not None:
                optimizer.load_state_dict(opt_state, params, saved_opt)
            else:
                print("The checkpoint holds no optimizer state: Adam "
                      "starts from zero moments")
            print(f"Resumed from checkpoint at step {total_steps}")

    log_dir = flags.log_dir("supervised")
    logger = ScalarLogger(log_dir)
    probe = (histogram_probe(config.sage, graph, B, flags.seed + 1, device)
             if flags.log_histograms else None)
    sampler_generator = torch.Generator(device=device).manual_seed(flags.seed)
    host_rng = np.random.default_rng(flags.seed)
    avg_time = 0.0
    timed_steps = 0   # steps timed in this process (not resumed ones)
    val_cost = val_f1_mic = val_f1_mac = 0.0
    stop = False
    profiler = (TrainingProfile(flags.profile_dir, device)
                if flags.profile_dir else None)

    chunk = max(1, min(flags.print_every, flags.validate_iter))
    for epoch in range(flags.epochs):
        print("Epoch: %04d" % (epoch + 1))
        ids_perm = torch.from_numpy(
            ids_padded[host_rng.permutation(len(ids_padded))]
        ).to(device)
        drop_seed = int(host_rng.integers(0, 2**63))
        it = 0
        while it < steps_per_epoch:
            n = min(chunk, steps_per_epoch - it,
                    max(1, flags.max_total_steps + 1 - total_steps))
            t = time.time()
            params, opt_state, loss, logits, last_ids = run_chunk(
                params, opt_state, sampler_generator, features, train_adj,
                ids_perm, labels_table_dev, it, n, drop_seed=drop_seed,
            )

            # validate when [it, it+n) crosses a multiple of validate_iter
            if (it + n - 1) % flags.validate_iter < n:
                if flags.validate_batch_size == -1:
                    val_cost, vp, vl, _ = full_eval(batcher.val_nodes)
                    val_f1_mic, val_f1_mac = calc_f1(vl, vp, sigmoid)
                else:
                    vb = batcher.sample_val_batch(flags.validate_batch_size)
                    vloss, vpred = eval_step(
                        params, features, full_adj,
                        torch.from_numpy(vb.ids).to(device),
                        torch.from_numpy(vb.labels).to(device),
                        torch.from_numpy(vb.mask).to(device),
                        eval_generator(),
                    )
                    val_cost = float(vloss)
                    k = int(vb.mask.sum())
                    val_f1_mic, val_f1_mac = calc_f1(
                        vb.labels[:k], vpred.cpu().numpy()[:k], sigmoid
                    )

            it += n
            total_steps += n
            timed_steps += n
            avg_time = (
                avg_time * (timed_steps - n) + time.time() - t
            ) / timed_steps

            if (total_steps - 1) % flags.print_every < n:
                ids_np = last_ids.cpu().numpy()
                keep = ids_np != dummy
                preds = supervised_predict(logits, config).cpu().numpy()
                f1_mic, f1_mac = calc_f1(
                    labels_table[ids_np[keep]], preds[keep], sigmoid
                )
                train_loss = float(loss)
                print(
                    "Iter:", "%04d" % (it - 1),
                    "train_loss=", "{:.5f}".format(train_loss),
                    "train_f1_mic=", "{:.5f}".format(f1_mic),
                    "train_f1_mac=", "{:.5f}".format(f1_mac),
                    "val_loss=", "{:.5f}".format(val_cost),
                    "val_f1_mic=", "{:.5f}".format(val_f1_mic),
                    "val_f1_mac=", "{:.5f}".format(val_f1_mac),
                    "time=", "{:.5f}".format(avg_time),
                )
                logger.log(
                    total_steps - 1, train_loss=train_loss,
                    train_f1_mic=f1_mic, train_f1_mac=f1_mac,
                    val_loss=val_cost, val_f1_mic=val_f1_mic,
                    val_f1_mac=val_f1_mac, step_time=avg_time,
                )
                if probe is not None:
                    logger.log_histograms(total_steps - 1, params)
                    logger.log_histograms(
                        total_steps - 1,
                        probe(params, features, train_adj), prefix="")

            if (flags.checkpoint_dir and flags.checkpoint_every
                    and total_steps % flags.checkpoint_every < n):
                ckpt.save(flags.checkpoint_dir, params, total_steps,
                          optimizer.state_dict(opt_state, params))
            if total_steps > flags.max_total_steps:
                stop = True
                break
        if stop:
            break
    if profiler is not None:
        profiler.stop()

    print("Optimization Finished!")
    val_cost, vp, vl, duration = full_eval(batcher.val_nodes)
    val_f1_mic, val_f1_mac = calc_f1(vl, vp, sigmoid)
    print(
        "Full validation stats:",
        "loss=", "{:.5f}".format(val_cost),
        "f1_micro=", "{:.5f}".format(val_f1_mic),
        "f1_macro=", "{:.5f}".format(val_f1_mac),
        "time=", "{:.5f}".format(duration),
    )
    _write_stats(log_dir + "/val_stats.txt", val_cost, val_f1_mic,
                 val_f1_mac, duration)
    logger.log(total_steps, final_val_loss=val_cost,
               final_val_f1_mic=val_f1_mic, final_val_f1_mac=val_f1_mac)
    logger.close()

    print("Writing test set stats to file (don't peak!)")
    test_cost, tp, tl, _ = full_eval(batcher.test_nodes)
    test_f1_mic, test_f1_mac = calc_f1(tl, tp, sigmoid)
    _write_stats(log_dir + "/test_stats.txt", test_cost, test_f1_mic,
                 test_f1_mac)

    if flags.checkpoint_dir:
        ckpt.save(flags.checkpoint_dir, params, total_steps,
                  optimizer.state_dict(opt_state, params))

    return {
        "params": params,
        "val_loss": val_cost,
        "val_f1_mic": val_f1_mic,
        "val_f1_mac": val_f1_mac,
        "test_f1_mic": test_f1_mic,
        "test_f1_mac": test_f1_mac,
        "steps": total_steps,
        "log_dir": log_dir,
    }
