"""Unsupervised training on one device, and the embedding export.

``train`` follows the JAX package's single-device loop: the padded pair
stream lives on the device; each epoch's pair permutation and its
negatives' uniforms ([steps, neg_sample_size]) are drawn on the host,
from a NumPy generator seeded by ``--seed``, copied to the device once
and mapped to node ids there against the unigram^0.75 CDF, so the card
and the CPU draw the same negatives. The chunk runner
(``parallel/dp.py``) runs up to ``min(print_every, validate_iter)``
steps between host synchronisations and carries the train-MRR EMA on
the device. Validation crosses ``validate_iter`` on the full adjacency
(a sampled batch of val edges, or all of them with
``validate_batch_size <= 0``) with one fixed set of negatives drawn
from ``seed + 1``; its EMA decays 0.99 per step toward the latest val
MRR. At the end every node's l2-normalised embedding goes to
``val.npy`` and its original id to ``val.txt``, in one sweep and one
copy to the host.

``--model n2v`` trains the node2vec tables instead (``_train_n2v``):
SGD over the pair stream, each chunk's unique negatives drawn as
Gumbel top-k from host noise (``sample_negatives_unique``: [steps, N+1]
float32 noise, drawn and copied in blocks of at most 16 MiB), so the
card and the CPU draw the same ids; with ``--save_embeddings`` it writes the
target table to ``val.npy``, retrains on fresh walks from the val and
test nodes with every other context row frozen, and writes the retrained
table to ``val-test.npy``.
"""

from __future__ import annotations

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
from graphsage_tpu_torch.parallel.dp import (
    make_node2vec_chunk_runner,
    make_unsupervised_chunk_runner,
)
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import (
    TrainFlags,
    build_layer_infos,
    feature_table,
    require_ported,
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


def fixed_negatives(cdf: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """The validation's negatives: ``n`` ids from uniforms of
    ``default_rng(seed)``, mapped on ``cdf``'s device."""
    u = np.random.default_rng(seed).random(n, dtype=np.float32)
    return negatives_from_uniforms(cdf, torch.from_numpy(u).to(cdf.device))


def embed_all_nodes(config: UnsupervisedConfig, batch_size: int, params,
                    features, adj, seed: int) -> np.ndarray:
    """[N, dim] embeddings of every node in id order, through the embed
    sweep with a sampler generator seeded ``seed`` on ``adj``'s device,
    copied to the host once. The trainer's export and ``embed`` both
    call it, so they agree bit for bit on one device."""
    n = config.sage.num_nodes
    n_b = max(1, -(-n // batch_size))
    ids_all = np.full((n_b * batch_size,), n, dtype=np.int32)
    ids_all[:n] = np.arange(n)
    generator = torch.Generator(device=adj.device).manual_seed(seed)
    rows = make_embed_sweep(config, batch_size)(
        params, features, adj, torch.from_numpy(ids_all).to(adj.device),
        generator)
    return rows[:n].cpu().numpy()


def write_embeddings(out_dir: str, rows: np.ndarray, node_ids: list,
                     mod: str = "") -> None:
    """val<mod>.npy (one row per node) and val<mod>.txt (the original
    ids)."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"val{mod}.npy"), rows)
    with open(os.path.join(out_dir, f"val{mod}.txt"), "w") as fp:
        fp.write("\n".join(map(str, node_ids)))


def train(flags: TrainFlags, graph=None, device="cuda") -> dict:
    """Train on ``device`` (``cuda`` unless the caller asks for ``cpu``);
    returns the params and the last val loss, MRR and val-MRR EMA."""
    require_ported(flags, "unsupervised")
    device = resolve_device(device)
    if graph is None:
        print("Loading training data..")
        graph = load_data(flags.train_prefix,
                          load_walks=flags.random_context,
                          load_features=not flags.defer_features,
                          degree_relabel=flags.degree_relabel)
        print("Done loading training data..")
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
    log_dir = flags.log_dir("unsupervised")
    if flags.model == "n2v":
        # node2vec reads no features: a deferred table stays on disk
        return _train_n2v(flags, graph, deg, batcher, log_dir, device)

    graph = materialize_features(graph)
    config = build_unsupervised_config(flags, graph)
    features = feature_table(graph, flags, device)
    train_adj = torch.from_numpy(train_adj_np).to(device)
    full_adj = torch.from_numpy(full_adj_np).to(device)
    neg_cdf = torch.from_numpy(unigram_cdf(deg)).to(device)

    params = init_unsupervised_params(
        torch.Generator().manual_seed(flags.seed), config, device
    )
    optimizer = make_optimizer(flags.learning_rate)
    opt_state = optimizer.init(params)

    B = flags.batch_size
    dummy = graph.num_nodes
    n_neg = flags.neg_sample_size
    pairs_padded = pad_pairs(batcher.train_pairs, B, dummy)
    steps_per_epoch = len(pairs_padded) // B
    run_chunk = make_unsupervised_chunk_runner(config, optimizer, B)

    eval_seed = flags.seed + 1
    val_negs = fixed_negatives(neg_cdf, n_neg, eval_seed)
    full_val = flags.validate_batch_size <= 0
    if full_val:
        eval_sweep = make_unsup_eval_sweep(config, B)
        val_pairs_dev = torch.from_numpy(
            pad_pairs(batcher.val_pairs, B, dummy)).to(device)
    else:
        eval_step = make_unsup_eval_step(config)

    def eval_generator():
        return torch.Generator(device=device).manual_seed(eval_seed)

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

    logger = ScalarLogger(log_dir)
    probe = (histogram_probe(config.sage, graph, B, eval_seed, device)
             if flags.log_histograms else None)
    sampler_generator = torch.Generator(device=device).manual_seed(flags.seed)
    host_rng = np.random.default_rng(flags.seed)
    train_shadow = torch.full((), -1.0, device=device)  # < 0: unset
    shadow_mrr = None
    val_cost = val_mrr = 0.0
    avg_time = 0.0
    timed_steps = 0   # steps timed in this process (not resumed ones)
    stop = False
    profiler = (TrainingProfile(flags.profile_dir, device)
                if flags.profile_dir else None)

    chunk = max(1, min(flags.print_every, flags.validate_iter))
    for epoch in range(flags.epochs):
        print("Epoch: %04d" % (epoch + 1))
        pairs_perm = torch.from_numpy(
            pairs_padded[host_rng.permutation(len(pairs_padded))]
        ).to(device)
        neg_u = host_rng.random((steps_per_epoch, n_neg), dtype=np.float32)
        neg_ids = negatives_from_uniforms(
            neg_cdf, torch.from_numpy(neg_u).to(device))
        drop_seed = int(host_rng.integers(0, 2**63))
        it = 0
        while it < steps_per_epoch:
            n = min(chunk, steps_per_epoch - it,
                    max(1, flags.max_total_steps + 1 - total_steps))
            t = time.time()
            params, opt_state, train_shadow, loss, train_mrr = run_chunk(
                params, opt_state, train_shadow, sampler_generator,
                features, train_adj, pairs_perm, neg_ids, it, n,
                drop_seed=drop_seed,
            )

            # validate when [it, it+n) crosses a multiple of validate_iter
            if (it + n - 1) % flags.validate_iter < n:
                if full_val:
                    val_cost, val_mrr = eval_sweep(
                        params, features, full_adj, val_pairs_dev, val_negs,
                        eval_generator())
                else:
                    vb = batcher.sample_val_batch(flags.validate_batch_size)
                    val_cost, val_mrr = eval_step(
                        params, features, full_adj,
                        torch.from_numpy(vb.batch1).to(device),
                        torch.from_numpy(vb.batch2).to(device),
                        torch.from_numpy(vb.mask).to(device), val_negs,
                        eval_generator())
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
                    "train_mrr_ema=", "{:.5f}".format(scal["train_mrr_ema"]),
                    "val_loss=", "{:.5f}".format(scal["val_loss"]),
                    "val_mrr=", "{:.5f}".format(scal["val_mrr"]),
                    "val_mrr_ema=", "{:.5f}".format(scal["val_mrr_ema"]),
                    "time=", "{:.5f}".format(avg_time),
                )
                logger.log(total_steps - 1, step_time=avg_time, **scal)
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
    logger.close()

    print("Optimization Finished!")
    if flags.save_embeddings:
        write_embeddings(log_dir, embed_all_nodes(
            config, B, params, features, full_adj, eval_seed),
            graph.node_ids)
    if flags.checkpoint_dir:
        ckpt.save(flags.checkpoint_dir, params, total_steps,
                  optimizer.state_dict(opt_state, params))

    return {
        "params": params,
        "val_loss": float(val_cost),
        "val_mrr": float(val_mrr),
        "shadow_mrr": float(shadow_mrr) if shadow_mrr is not None else 0.0,
        "train_mrr_ema": float(train_shadow),
        "steps": total_steps,
        "log_dir": log_dir,
    }


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
