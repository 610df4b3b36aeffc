"""Unsupervised training, on one device or several, and the embedding
export.

``train`` follows the JAX package's loop: the padded pair stream lives
on the device; each epoch's pair permutation and its negatives'
uniforms ([steps, neg_sample_size]) are drawn on the host, from a NumPy
generator seeded by ``--seed``, copied to the device once and mapped to
node ids there against the unigram^0.75 CDF, so the card and the CPU
draw the same negatives. The chunk runner (``parallel/dp.py``) runs up
to ``min(print_every, validate_iter)`` steps between host
synchronisations and carries the train-MRR EMA on the device.
Validation crosses ``validate_iter`` on the full adjacency (a sampled
batch of val edges, or all of them with ``validate_batch_size <= 0``)
with one fixed set of negatives drawn from ``seed + 1``; its EMA decays
0.99 per step toward the latest val MRR. At the end every node's
l2-normalised embedding goes to ``val.npy`` and its original id to
``val.txt``, in one sweep and one copy to the host.

Multi-device runs (one process per device, ``parallel/launch.py``) go
through the same loop with other pieces (``_Pieces``), as
``train/supervised.py`` does: ``--data_shards M`` alone swaps in the
data-parallel runner, every rank holding the whole tables and drawing
the same negatives (``_replicated_pieces``; rank 0 validates and
exports alone); ``--graph_shards N`` (with ``--data_shards M``: an
M x N grid) row-shards the tables over each graph group, each rank
drawing its own negatives ([steps, ranks, n_neg] uniforms) and each
graph rank validating against its own set, the ranks validating and
exporting together (``_sharded_pieces``, ``parallel/graph_sharded.py``;
the export's sampler seed is ``seed + 2``, as in the JAX package). Rank
0 prints and writes the logs, embeddings and checkpoints; a checkpoint
keeps the identity table in canonical id order, so a run resumes under
any shard count or layout.

``--model n2v`` trains the node2vec tables instead (``_train_n2v``), on
one device whatever the shard flags say, as in the JAX package: SGD
over the pair stream, each chunk's unique negatives drawn as Gumbel
top-k from host noise (``sample_negatives_unique``: [steps, N+1]
float32 noise, drawn and copied in blocks of at most 16 MiB), so the
card and the CPU draw the same ids; with ``--save_embeddings`` it
writes the target table to ``val.npy``, retrains on fresh walks from
the val and test nodes with every other context row frozen, and writes
the retrained table to ``val-test.npy``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from graphsage_tpu_torch.data.adjacency import build_both_adjs
from graphsage_tpu_torch.data.io import load_data, materialize_features
from graphsage_tpu_torch.data.minibatch import EdgeBatcher
from graphsage_tpu_torch.data.walks import run_random_walks
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.models import node2vec as n2v
from graphsage_tpu_torch.models.graphsage import (
    SAGEConfig,
    l2_normalize,
    sage_embed,
)
from graphsage_tpu_torch.models.supervised import make_optimizer
from graphsage_tpu_torch.models.unsupervised import (
    UnsupervisedConfig,
    init_unsupervised_params,
    unsupervised_loss,
)
from graphsage_tpu_torch.nn.negative import (
    negatives_from_uniforms,
    sample_negatives_unique,
    unigram_cdf,
    unigram_logits,
)
from graphsage_tpu_torch.parallel.distributed import (
    fold_seed,
    host_array,
    make_grid,
)
from graphsage_tpu_torch.parallel.dp import (
    make_dp_unsupervised_chunk_runner,
    make_node2vec_chunk_runner,
    make_unsupervised_chunk_runner,
)
from graphsage_tpu_torch.parallel.graph_sharded import (
    local_shard,
    make_sharded_embed_sweep,
    make_sharded_unsup_eval_sweep,
    make_sharded_unsupervised_chunk_runner,
    make_sharded_unsupervised_eval,
    reassemble_sharded_rows,
    suggest_capacity_factor,
)
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import (
    TrainFlags,
    build_layer_infos,
    feature_table,
    require_ported,
)
from graphsage_tpu_torch.train.sharding import (
    DroppedRequests,
    canonical_state,
    local_state,
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


def build_unsupervised_config(flags: TrainFlags,
                              graph) -> UnsupervisedConfig:
    agg, concat, layers = build_layer_infos(flags, supervised=False)
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
    return UnsupervisedConfig(sage=sage, weight_decay=flags.weight_decay)


def make_embed_sweep(config: UnsupervisedConfig, batch_size: int):
    """sweep(params, features, adj, ids_all, generator) -> [n_b*B, dim]
    l2-normalised embeddings of a dummy-padded id stream, on the
    device, written batch by batch into one preallocated tensor."""

    @torch.inference_mode()
    def sweep(params, features, adj, ids_all, generator=None):
        n_b = ids_all.shape[0] // batch_size
        out = torch.empty(n_b * batch_size, config.sage.output_dim,
                          device=ids_all.device)
        for i in range(n_b):
            rows = slice(i * batch_size, (i + 1) * batch_size)
            out[rows] = l2_normalize(sage_embed(
                params, features, adj, ids_all[rows], config.sage,
                generator=generator, deterministic=True), 1)
        return out

    return sweep


def make_unsup_eval_step(config: UnsupervisedConfig):
    """eval_step(params, features, adj, b1, b2, mask, neg_ids, generator)
    -> (loss, mrr) on one batch, no dropout, on the device."""

    @torch.inference_mode()
    def eval_step(params, features, adj, b1, b2, mask, neg_ids,
                  generator=None):
        loss, aux = unsupervised_loss(
            params, features, adj, b1, b2, mask, neg_ids, config,
            generator=generator, deterministic=True,
        )
        return loss, aux["mrr"]

    return eval_step


def make_unsup_eval_sweep(config: UnsupervisedConfig, batch_size: int):
    """sweep(params, features, adj, pairs_all, neg_ids, generator) ->
    (loss, mrr): the means over every real pair of a dummy-padded pair
    stream (each batch weighted by its real pairs), on the device."""
    eval_step = make_unsup_eval_step(config)
    num_nodes = config.sage.num_nodes

    @torch.inference_mode()
    def sweep(params, features, adj, pairs_all, neg_ids, generator=None):
        loss_sum = mrr_sum = count = torch.zeros((), device=pairs_all.device)
        for i in range(pairs_all.shape[0] // batch_size):
            pair = pairs_all[i * batch_size:(i + 1) * batch_size]
            mask = (pair[:, 0] != num_nodes).float()
            loss, mrr = eval_step(params, features, adj, pair[:, 0],
                                  pair[:, 1], mask, neg_ids, generator)
            k = mask.sum()
            loss_sum, mrr_sum = loss_sum + loss * k, mrr_sum + mrr * k
            count = count + k
        count = torch.clamp(count, min=1.0)
        return loss_sum / count, mrr_sum / count

    return sweep


def pad_pairs(pairs: np.ndarray, batch_size: int, dummy: int) -> np.ndarray:
    """Dummy-pad an [E, 2] pair array to a multiple of batch_size."""
    n_b = max(1, -(-len(pairs) // batch_size))
    out = np.full((n_b * batch_size, 2), dummy, dtype=np.int32)
    out[: len(pairs)] = pairs
    return out


def fixed_negatives(cdf: torch.Tensor, n, seed: int) -> torch.Tensor:
    """The validation's negatives: ids of shape ``n`` (an int, or
    (sets, n_neg): the uniforms of one set after another) from uniforms
    of ``default_rng(seed)``, mapped on ``cdf``'s device."""
    u = np.random.default_rng(seed).random(n, dtype=np.float32)
    return negatives_from_uniforms(cdf, torch.from_numpy(u).to(cdf.device))


def embed_all_nodes(config: UnsupervisedConfig, batch_size: int, params,
                    features, adj, seed: int) -> np.ndarray:
    """[N, dim] embeddings of every node in id order, through the embed
    sweep with a sampler generator seeded ``seed`` on ``adj``'s device,
    copied to the host once. The trainer's export and ``embed`` both
    call it, so they agree bit for bit on one device."""
    n = config.sage.num_nodes
    generator = torch.Generator(device=adj.device).manual_seed(seed)
    rows = make_embed_sweep(config, batch_size)(
        params, features, adj, _node_stream(n, batch_size, adj.device),
        generator)
    return rows[:n].cpu().numpy()


def _node_stream(n: int, batch_size: int, device) -> torch.Tensor:
    """Every node id in order, dummy-padded to whole batches, on
    ``device``."""
    n_b = max(1, -(-n // batch_size))
    ids_all = np.full((n_b * batch_size,), n, dtype=np.int32)
    ids_all[:n] = np.arange(n)
    return torch.from_numpy(ids_all).to(device)


def write_embeddings(out_dir: str, rows: np.ndarray, node_ids: list,
                     mod: str = "") -> None:
    """val<mod>.npy (one row per node) and val<mod>.txt (the original
    ids)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"val{mod}.npy"), rows)
    with open(os.path.join(out_dir, f"val{mod}.txt"), "w") as fp:
        fp.write("\n".join(map(str, node_ids)))


def sharded_embed_all_nodes(config: UnsupervisedConfig, grid, batch_size: int,
                            params, feat_local, adj_local, seed: int,
                            capacity_factor: float):
    """``embed_all_nodes`` over tables row-sharded across ``grid``: the
    sharded embed sweep (``parallel/graph_sharded.py``) of every node,
    each batch split over the whole grid, the sampler seeded ``seed`` on
    every rank -> ([N, dim] rows in id order on every rank, dropped). A
    collective call; the trainer's export and ``embed`` both make it
    with ``seed + 2``, as the JAX package's sharded pair does, so they
    agree bit for bit."""
    n = config.sage.num_nodes
    ids_all = _node_stream(n, batch_size, adj_local.device)
    generator = torch.Generator(device=adj_local.device).manual_seed(seed)
    rows, dropped = make_sharded_embed_sweep(
        config, grid, batch_size, capacity_factor=capacity_factor)(
            params, feat_local, adj_local, ids_all, generator)
    rows = reassemble_sharded_rows(host_array(rows), grid.total,
                                   ids_all.shape[0] // batch_size)
    return rows[:n], dropped


def train(flags: TrainFlags, graph=None, device="cuda") -> dict:
    """Train on ``device`` (``cuda`` unless the caller asks for ``cpu``);
    returns the params and the last val loss, MRR and val-MRR EMA. With
    ``--graph_shards`` or ``--data_shards`` above 1 this process is one
    rank of an initialised process group (``parallel/launch.py``), on
    its own device; the metrics are rank 0's. ``--model n2v`` trains on
    this one device whatever the shard flags say, as the JAX package's
    node2vec does."""
    device = resolve_device(device)
    n2v_model = flags.model == "n2v"
    if not n2v_model:
        require_ported(flags)
    sharded = not n2v_model and flags.graph_shards > 1
    grid = (make_grid(flags.graph_shards, flags.data_shards)
            if not n2v_model and (sharded or flags.data_shards > 1)
            else None)
    chief = grid is None or grid.is_chief
    say = print if chief else quiet
    if graph is None:
        say("Loading training data..")
        graph = load_data(flags.train_prefix,
                          load_walks=flags.random_context,
                          load_features=not flags.defer_features,
                          degree_relabel=flags.degree_relabel)
        say("Done loading training data..")
    if flags.random_context and graph.walks is None:
        raise ValueError("--random_context needs the walk pairs "
                         "(<prefix>-walks.txt, or graph.walks)")

    train_adj_np, deg, full_adj_np = build_both_adjs(
        graph, flags.max_degree, seed=flags.seed
    )
    batcher = EdgeBatcher(
        graph, deg, flags.batch_size,
        context_pairs=graph.walks if flags.random_context else None,
        seed=flags.seed,
    )
    if n2v_model:
        # node2vec reads no features: a deferred table stays on disk
        return _train_n2v(flags, graph, deg, batcher,
                          flags.log_dir("unsupervised"), device)

    if not sharded:   # whole tables: a deferred table is read whole now
        graph = materialize_features(graph)
    config = build_unsupervised_config(flags, graph)
    neg_cdf = torch.from_numpy(unigram_cdf(deg)).to(device)
    optimizer = make_optimizer(flags.learning_rate)
    make_pieces = _sharded_pieces if sharded else _replicated_pieces
    pc = make_pieces(flags, graph, config, optimizer, grid, batcher,
                     train_adj_np, full_adj_np, neg_cdf, device, say)
    params = pc.params
    opt_state = optimizer.init(params)
    drops = DroppedRequests(pc.capacity_factor, say)

    B = flags.batch_size
    n_neg = flags.neg_sample_size
    pairs_padded = pad_pairs(batcher.train_pairs, B, graph.num_nodes)
    steps_per_epoch = len(pairs_padded) // B
    # the epoch's negatives: one set a step, or one a step for each rank
    neg_shape = ((steps_per_epoch, n_neg) if pc.neg_sets is None
                 else (steps_per_epoch, pc.neg_sets, n_neg))
    full_val = flags.validate_batch_size <= 0

    def eval_generator():
        # the same on every rank, so a sharded evaluation samples as the
        # single-device one does
        return torch.Generator(device=device).manual_seed(flags.seed + 1)

    def save(step):
        saved, saved_opt = pc.to_saved(
            params, optimizer.state_dict(opt_state, params))
        if chief:
            ckpt.save(flags.checkpoint_dir, saved, step, saved_opt)

    total_steps = 0
    if flags.checkpoint_dir and flags.resume:
        total_steps = restore(flags, params, optimizer, opt_state,
                              pc.saved_like, pc.to_local, device, say)

    # rank 0 logs; it validates alone unless the tables are sharded
    evaluates = chief or pc.collective
    log_dir = flags.log_dir("unsupervised") if chief else None
    logger = ScalarLogger(log_dir) if chief else None
    probe = (histogram_probe(config.sage, graph, B, flags.seed + 1, device)
             if flags.log_histograms and chief and not sharded else None)
    sampler_generator = torch.Generator(device=device).manual_seed(
        flags.seed if grid is None else fold_seed(flags.seed, grid.me))
    host_rng = np.random.default_rng(flags.seed)
    train_shadow = torch.full((), -1.0, device=device)  # < 0: unset
    shadow_mrr = None
    val_cost = val_mrr = 0.0
    avg_time = 0.0
    timed_steps = 0   # steps timed in this process (not resumed ones)
    stop = False
    # overflow drops add up on the device; the host reads them at prints
    pending_dropped = 0
    profiler = (TrainingProfile(flags.profile_dir, device)
                if flags.profile_dir and chief else None)

    chunk = max(1, min(flags.print_every, flags.validate_iter))
    for epoch in range(flags.epochs):
        say("Epoch: %04d" % (epoch + 1))
        pairs_perm = torch.from_numpy(
            pairs_padded[host_rng.permutation(len(pairs_padded))]
        ).to(device)
        neg_u = host_rng.random(neg_shape, dtype=np.float32)
        neg_ids = negatives_from_uniforms(
            neg_cdf, torch.from_numpy(neg_u).to(device))
        drop_seed = int(host_rng.integers(0, 2**63))
        it = 0
        while it < steps_per_epoch:
            n = min(chunk, steps_per_epoch - it,
                    max(1, flags.max_total_steps + 1 - total_steps))
            t = time.time()
            out = pc.run_chunk(
                params, opt_state, train_shadow, sampler_generator,
                pc.features, pc.train_adj, pairs_perm, neg_ids, it, n,
                drop_seed=drop_seed,
            )
            params, opt_state, train_shadow, loss, train_mrr = out[:5]
            if sharded:
                pending_dropped = pending_dropped + out[5]

            # validate when [it, it+n) crosses a multiple of validate_iter
            if evaluates and (it + n - 1) % flags.validate_iter < n:
                if full_val:
                    val_cost, val_mrr, vdropped = pc.sweep(
                        params, eval_generator())
                else:
                    # a sampled batch has batch_size rows (a multiple of
                    # the graph group): <= 0 sweeps, as in the JAX package
                    vb = batcher.sample_val_batch(flags.validate_batch_size)
                    val_cost, val_mrr, vdropped = pc.eval_batch(
                        params, vb, eval_generator())
                drops.note(vdropped, "validation")
            if shadow_mrr is None:
                shadow_mrr = val_mrr
            else:
                # the reference decays the EMA 0.99 every step toward the
                # latest val MRR: over a chunk of n steps, 0.99**n
                shadow_mrr = val_mrr + (shadow_mrr - val_mrr) * 0.99 ** n

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
                if chief:
                    scal = {
                        "train_loss": float(loss),
                        "train_mrr": float(train_mrr),
                        "train_mrr_ema": float(train_shadow),
                        "val_loss": float(val_cost),
                        "val_mrr": float(val_mrr),
                        "val_mrr_ema": float(shadow_mrr),
                    }
                    print(
                        "Iter:", "%04d" % (it - 1),
                        "train_loss=", "{:.5f}".format(scal["train_loss"]),
                        "train_mrr=", "{:.5f}".format(scal["train_mrr"]),
                        "train_mrr_ema=",
                        "{:.5f}".format(scal["train_mrr_ema"]),
                        "val_loss=", "{:.5f}".format(scal["val_loss"]),
                        "val_mrr=", "{:.5f}".format(scal["val_mrr"]),
                        "val_mrr_ema=", "{:.5f}".format(scal["val_mrr_ema"]),
                        "time=", "{:.5f}".format(avg_time),
                    )
                    logger.log(total_steps - 1, step_time=avg_time, **scal)
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
    if flags.save_embeddings:
        rows, dropped = pc.export(params)
        drops.note(dropped, "embedding export")
        if chief:
            write_embeddings(log_dir, rows, graph.node_ids)
    if flags.checkpoint_dir:
        save(total_steps)
    if chief:
        logger.close()

    return {
        "params": params,
        "val_loss": float(val_cost),
        "val_mrr": float(val_mrr),
        "shadow_mrr": float(shadow_mrr) if shadow_mrr is not None else 0.0,
        "train_mrr_ema": float(train_shadow),
        "steps": total_steps,
        "log_dir": log_dir,
        "dropped": drops.total,
    }


# ------------------------------------------------- the trainer's modes

@dataclasses.dataclass
class _Pieces:
    """What a mode hands ``train``'s loop: this rank's tables and params,
    the chunk runner, and the evaluation, export and checkpoint
    functions.

    - ``run_chunk``: the runners' call; its first five outputs are
      (params, opt_state, shadow, last_loss, last_mrr), a sharded
      runner's sixth the chunk's dropped count;
    - ``neg_sets``: the epoch's negatives have one set a step
      (``None``) or ``neg_sets`` a step, one for each rank;
    - ``eval_batch(params, vb, generator)`` -> (loss, mrr, dropped) of a
      sampled val batch; ``sweep(params, generator)`` the same over
      every val pair;
    - ``export(params)`` -> (every node's embedding [N, dim] on the host,
      in id order, dropped);
    - ``to_saved(params, opt_state_dict)`` and ``to_local(tree)``: a
      checkpoint's whole, canonical state from this rank's and back
      (``saved_like`` gives the checkpoint's shapes);
    - ``collective``: every rank takes part in the evaluations, the
      export and the saves (the tables are sharded); else rank 0 runs
      them alone.
    """

    features: object
    train_adj: torch.Tensor
    params: dict
    run_chunk: object
    neg_sets: int | None
    eval_batch: object
    sweep: object
    export: object
    to_saved: object
    to_local: object
    saved_like: dict
    collective: bool
    capacity_factor: float = 0.0


def _val_pairs(flags, batcher, num_nodes: int, device):
    """The padded val pair stream on the device, for the full sweep."""
    if flags.validate_batch_size > 0:
        return None
    return torch.from_numpy(pad_pairs(batcher.val_pairs, flags.batch_size,
                                      num_nodes)).to(device)


def _edge_batch(vb, device):
    return tuple(torch.from_numpy(x).to(device)
                 for x in (vb.batch1, vb.batch2, vb.mask))


def _replicated_pieces(flags, graph, config, optimizer, grid, batcher,
                       train_adj_np, full_adj_np, neg_cdf, device, say):
    """One device, or ``--data_shards M`` alone (``grid``): every rank
    holds the whole tables and params; one set of val negatives, drawn
    from ``seed + 1``."""
    B = flags.batch_size
    features = feature_table(graph, flags, device)
    full_adj = torch.from_numpy(full_adj_np).to(device)
    params = init_unsupervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    )
    if grid is None:
        run_chunk = make_unsupervised_chunk_runner(config, optimizer, B)
    else:
        run_chunk = make_dp_unsupervised_chunk_runner(config, optimizer,
                                                      grid, B)
    val_negs = fixed_negatives(neg_cdf, flags.neg_sample_size, flags.seed + 1)
    val_pairs = _val_pairs(flags, batcher, graph.num_nodes, device)
    eval_step = make_unsup_eval_step(config)
    eval_sweep = make_unsup_eval_sweep(config, B)

    def eval_batch(params, vb, generator):
        return (*eval_step(params, features, full_adj, *_edge_batch(
            vb, device), val_negs, generator), 0)

    def sweep(params, generator):
        return (*eval_sweep(params, features, full_adj, val_pairs, val_negs,
                            generator), 0)

    def export(params):
        return embed_all_nodes(config, B, params, features, full_adj,
                               flags.seed + 1), 0

    return _Pieces(
        features=features,
        train_adj=torch.from_numpy(train_adj_np).to(device), params=params,
        run_chunk=run_chunk, neg_sets=None, eval_batch=eval_batch,
        sweep=sweep, export=export, to_saved=lambda params, opt: (params,
                                                                  opt),
        to_local=lambda tree: tree, saved_like=params, collective=False)


def _sharded_pieces(flags, graph, config, optimizer, grid, batcher,
                    train_adj_np, full_adj_np, neg_cdf, device, say):
    """--graph_shards N (x --data_shards M): the feature, adjacency and
    identity tables row-sharded over each graph group, every frontier
    gather through the all-to-all exchange, each batch split over the
    whole grid (``parallel/graph_sharded.py``). Each rank draws its own
    train negatives, each graph rank its own set of val negatives (row
    g of ``[D, n_neg]`` uniforms from ``seed + 1``: at one shard the
    single-device set)."""
    D, g, layout = grid.graph_size, grid.graph_rank, flags.shard_layout
    B = flags.batch_size
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
    params, saved_like = sharded_params(init_unsupervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    ), grid, layout)
    val_negs = fixed_negatives(neg_cdf, (D, flags.neg_sample_size),
                               flags.seed + 1)
    val_pairs = _val_pairs(flags, batcher, graph.num_nodes, device)
    eval_fn = make_sharded_unsupervised_eval(config, grid,
                                             capacity_factor=cap_factor)
    eval_sweep = make_sharded_unsup_eval_sweep(config, grid, B,
                                               capacity_factor=cap_factor)

    def eval_batch(params, vb, generator):
        return eval_fn(params, feat_local, full_adj,
                       *_edge_batch(vb, device), val_negs, generator)

    def sweep(params, generator):
        return eval_sweep(params, feat_local, full_adj, val_pairs, val_negs,
                          generator)

    def export(params):
        return sharded_embed_all_nodes(config, grid, B, params, feat_local,
                                       full_adj, flags.seed + 2, cap_factor)

    return _Pieces(
        features=feat_local,
        train_adj=torch.from_numpy(
            local_shard(train_adj_np, D, g, layout)).to(device),
        params=params,
        run_chunk=make_sharded_unsupervised_chunk_runner(
            config, optimizer, grid, B, capacity_factor=cap_factor),
        neg_sets=grid.total, eval_batch=eval_batch, sweep=sweep,
        export=export,
        to_saved=lambda params, opt: canonical_state(
            params, opt, grid, layout, n_rows),
        to_local=lambda tree: local_state(tree, grid, layout),
        saved_like=saved_like, collective=True, capacity_factor=cap_factor)


def _train_n2v(flags: TrainFlags, graph, deg, batcher: EdgeBatcher,
               log_dir: str, device) -> dict:
    """node2vec over the batcher's pairs, then, with --save_embeddings,
    the inductive retrain: fresh walks over the full graph from the val
    and test nodes, every context row but theirs frozen, a fresh SGD
    state, ``n2v_test_epochs`` epochs."""
    num_nodes = graph.num_nodes
    config = n2v.Node2VecConfig(
        num_nodes=num_nodes + 1, dim=2 * flags.dim_1,
        neg_sample_size=flags.neg_sample_size,
        learning_rate=flags.learning_rate)
    params = n2v.init_node2vec_params(
        torch.Generator().manual_seed(flags.seed), config, device)
    optimizer = n2v.make_optimizer(flags.learning_rate)
    logits = unigram_logits(
        np.concatenate([deg, [0]]).astype(np.float32)).to(device)
    host_rng = np.random.default_rng(flags.seed)
    B = flags.batch_size
    logger = ScalarLogger(log_dir)

    def run_epochs(n_epochs, pairs, update_mask, verbose):
        """SGD from a fresh state over ``pairs``, epochs of chunks of
        ``print_every`` steps; returns the steps run."""
        opt_state = optimizer.init(params)
        pairs_padded = pad_pairs(pairs, B, num_nodes)
        steps_per_epoch = len(pairs_padded) // B
        run_chunk = make_node2vec_chunk_runner(
            config, optimizer, B, num_nodes,
            with_update_mask=update_mask is not None)
        shadow = torch.full((), -1.0, device=device)   # < 0: unset
        total = 0
        avg_time = 0.0
        chunk = max(1, flags.print_every)
        for epoch in range(n_epochs):
            if verbose:
                print("Epoch: %04d" % (epoch + 1))
            pairs_perm = torch.from_numpy(
                pairs_padded[host_rng.permutation(len(pairs_padded))]
            ).to(device)
            it = 0
            while it < steps_per_epoch:
                n = min(chunk, steps_per_epoch - it,
                        max(1, flags.max_total_steps + 1 - total))
                t = time.time()
                negs = sample_negatives_unique(
                    host_rng, logits, config.neg_sample_size, n)
                _, opt_state, shadow, loss, mrr = run_chunk(
                    params, opt_state, shadow, pairs_perm, negs, it, n,
                    update_mask)
                it += n
                total += n
                avg_time = (avg_time * (total - n) + time.time() - t) / total
                if verbose and (total - 1) % flags.print_every < n:
                    scal = {"train_loss": float(loss),
                            "train_mrr": float(mrr),
                            "train_mrr_ema": float(shadow)}
                    print("Iter:", "%04d" % (it - 1),
                          "train_loss=", "{:.5f}".format(scal["train_loss"]),
                          "train_mrr=", "{:.5f}".format(scal["train_mrr"]),
                          "train_mrr_ema=",
                          "{:.5f}".format(scal["train_mrr_ema"]),
                          "time=", "{:.5f}".format(avg_time))
                    logger.log(total - 1, step_time=avg_time, **scal)
                if total > flags.max_total_steps:
                    return total
        return total

    total_steps = run_epochs(flags.epochs, batcher.train_pairs, None, True)
    logger.close()
    print("Optimization Finished!")
    if flags.save_embeddings:
        write_embeddings(log_dir, _target_rows(params, num_nodes),
                         graph.node_ids)
        evalnodes = np.flatnonzero(graph.is_val | graph.is_test)
        pairs = run_random_walks(graph.neighbors, evalnodes,
                                 rng=np.random.default_rng(flags.seed))
        # fixed_n2v: contexts are train nodes, whose frozen rows carry
        # the signal
        retrain = EdgeBatcher(graph, deg, B, context_pairs=pairs,
                              seed=flags.seed, n2v_retrain=True,
                              fixed_n2v=True)
        update_mask = torch.zeros(num_nodes + 1, device=device)
        update_mask[torch.from_numpy(evalnodes).to(device)] = 1.0
        run_epochs(flags.n2v_test_epochs, retrain.train_pairs, update_mask,
                   False)
        write_embeddings(log_dir, _target_rows(params, num_nodes),
                         graph.node_ids, mod="-test")
    return {"params": params, "steps": total_steps, "log_dir": log_dir}


def _target_rows(params, num_nodes: int) -> np.ndarray:
    """The target table's node rows in id order, on the host."""
    return params["target"].detach()[:num_nodes].cpu().numpy()
