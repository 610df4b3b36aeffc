"""The training steps and chunk runners: on one device, the pure
data-parallel supervised and unsupervised runners (P1,
``--data_shards``) and the tensor-parallel supervised runner
(``--n_model_shards``, with ``--data_shards``: a data x model grid).

The JAX package jits one function per step (forward, backward, the
clipped Adam update) and runs a chunk of steps in one ``fori_loop``
dispatch over a device-resident epoch stream. Here the step runs
eagerly and a Python loop over the chunk's steps takes the place of the
``fori_loop``: the epoch's id stream and the label table stay on the
device, each step slices its ids and takes its labels there, and
nothing is copied to the host inside a chunk. The host synchronises
only where the caller reads a result (the print and validate
boundaries of ``train/supervised.py`` and ``train/unsupervised.py``).

Under ``--data_shards M`` each of M ranks holds the whole tables and
takes B/M rows of every step's batch; the gradients are summed over the
ranks by hand (``distributed.all_reduce_grads``), after each rank's loss
was normalised by the world's mask sum. DDP would average the gradients
instead, which equals that sum only when every rank holds as many real
rows, and a dummy-padded tail batch breaks that.

Under ``--n_model_shards M`` each data slice's M ranks hold column
blocks of the tables and the layer-0 weights' matching rows
(``tensor.py``) and take the same rows of each batch; the layer-0
products are summed over the model group inside the model, and the
gradients over the data group.

The one-device supervised runner marks its chunk, each step, the
backward and the optimizer's update as spans (``trace.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from graphsage_tpu_torch.models.graphsage import sage_embed
from graphsage_tpu_torch.models.node2vec import (
    Node2VecConfig,
    mask_context_gradients,
    node2vec_loss,
)
from graphsage_tpu_torch.models.supervised import (
    SupervisedConfig,
    per_node_loss,
    supervised_logits,
    supervised_loss,
)
from graphsage_tpu_torch.models.unsupervised import (
    UnsupervisedConfig,
    unsupervised_loss,
)
from graphsage_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    fold_seed,
)
from graphsage_tpu_torch.trace import span


def _require_num_nodes(num_nodes: int, stream: str = "stream") -> None:
    """Factories that pad device-resident streams with the dummy id
    ``num_nodes`` must reject an unset config: left at the default 0,
    the pad id would silently mask out node 0 instead of the pad rows."""
    if num_nodes <= 0:
        raise ValueError(
            "config.sage.num_nodes must be set (> 0): it is the dummy "
            f"pad id for the device-resident {stream} — left at the "
            "default 0 it would silently mask out node 0 instead of "
            "the pad rows"
        )


def make_supervised_train_step(config: SupervisedConfig, optimizer):
    """step(params, opt_state, generator, features, adj, ids, labels,
    mask, drop_key=None) -> (params, opt_state, loss, logits).

    ``params`` (a flat dict of leaf tensors) and ``opt_state`` (from
    ``optimizer.init(params)``) are updated in place and returned.
    ``generator`` drives the sampler and the plain dropouts;
    ``drop_key`` = (seed, step) keys the fused hop's in-kernel dropout.
    """

    def step(params, opt_state, generator, features, adj, ids, labels, mask,
             drop_key=None):
        opt_state.zero_grad(set_to_none=True)
        loss, logits = supervised_loss(
            params, features, adj, ids, labels, mask, config,
            generator=generator, deterministic=False, drop_key=drop_key,
        )
        with span("backward"):
            loss.backward()
        with span("optimizer"):
            optimizer.update(opt_state, params)
        return params, opt_state, loss.detach(), logits.detach()

    return step


def make_supervised_chunk_runner(config: SupervisedConfig, optimizer,
                                 batch_size: int):
    """runner(params, opt_state, generator, features, adj, ids_perm,
    labels_table, start_step, n_steps, drop_seed=0) -> (params,
    opt_state, last_loss, last_logits, last_ids).

    Runs steps ``start_step .. start_step + n_steps - 1`` of an epoch
    whose shuffled, dummy-padded id stream ``ids_perm`` and label table
    (N+1 rows) live on the device; step i reads ids
    ``ids_perm[i*B:(i+1)*B]``, masks them with ``ids != N`` and keys its
    in-kernel dropout with (``drop_seed``, i), as the JAX runner folds
    the step index into its key. Results stay on the device.
    """
    num_nodes = config.sage.num_nodes
    _require_num_nodes(num_nodes, "id stream")
    step_fn = make_supervised_train_step(config, optimizer)

    def runner(params, opt_state, generator, features, adj, ids_perm,
               labels_table, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        with span("train.chunk"):
            for i in range(start_step, start_step + n_steps):
                with span("train.step"):
                    ids = ids_perm[i * batch_size:(i + 1) * batch_size]
                    labels = labels_table.index_select(0, ids)
                    mask = (ids != num_nodes).float()
                    params, opt_state, loss, logits = step_fn(
                        params, opt_state, generator, features, adj, ids,
                        labels, mask, drop_key=(drop_seed, i),
                    )
        return params, opt_state, loss, logits, ids

    return runner


def make_unsupervised_train_step(config: UnsupervisedConfig, optimizer):
    """step(params, opt_state, generator, features, adj, b1, b2, mask,
    neg_ids, drop_key=None) -> (params, opt_state, loss, aux).

    As ``make_supervised_train_step``; ``neg_ids`` are the step's
    negatives, drawn by the caller."""

    def step(params, opt_state, generator, features, adj, b1, b2, mask,
             neg_ids, drop_key=None):
        opt_state.zero_grad(set_to_none=True)
        loss, aux = unsupervised_loss(
            params, features, adj, b1, b2, mask, neg_ids, config,
            generator=generator, deterministic=False, drop_key=drop_key,
        )
        loss.backward()
        optimizer.update(opt_state, params)
        return params, opt_state, loss.detach(), aux

    return step


def mrr_ema(shadow, mrr, decay: float = 0.99):
    """The train-MRR EMA on the device: a negative ``shadow`` is the
    unset sentinel and takes ``mrr`` as it is."""
    return torch.where(shadow < 0, mrr, shadow - (1 - decay) * (shadow - mrr))


def make_unsupervised_chunk_runner(config: UnsupervisedConfig, optimizer,
                                   batch_size: int):
    """runner(params, opt_state, shadow_mrr, generator, features, adj,
    pairs_perm, neg_ids, start_step, n_steps, drop_seed=0) -> (params,
    opt_state, shadow_mrr, last_loss, last_mrr).

    Runs steps ``start_step .. start_step + n_steps - 1`` of an epoch
    whose shuffled, dummy-padded pair stream ``pairs_perm`` [P, 2] and
    negatives ``neg_ids`` [steps, n_neg] live on the device: step i
    takes pairs ``pairs_perm[i*B:(i+1)*B]``, masks them with
    ``b1 != N``, takes negatives ``neg_ids[i]`` and keys its in-kernel
    dropout with (``drop_seed``, i). The train-MRR EMA ``shadow_mrr``
    (a device scalar, < 0 until set) is carried through the steps.
    Results stay on the device.
    """
    num_nodes = config.sage.num_nodes
    _require_num_nodes(num_nodes, "pair stream")
    step_fn = make_unsupervised_train_step(config, optimizer)

    def runner(params, opt_state, shadow_mrr, generator, features, adj,
               pairs_perm, neg_ids, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        for i in range(start_step, start_step + n_steps):
            pair = pairs_perm[i * batch_size:(i + 1) * batch_size]
            b1, b2 = pair[:, 0], pair[:, 1]
            mask = (b1 != num_nodes).float()
            params, opt_state, loss, aux = step_fn(
                params, opt_state, generator, features, adj, b1, b2, mask,
                neg_ids[i], drop_key=(drop_seed, i),
            )
            shadow_mrr = mrr_ema(shadow_mrr, aux["mrr"])
        return params, opt_state, shadow_mrr, loss, aux["mrr"]

    return runner


def _check_update_mask(with_update_mask: bool, update_mask) -> None:
    """The factory's flag and the runtime mask must agree: a flag
    without a mask has nothing to freeze with, and a mask without the
    flag would train with the freeze silently dropped."""
    if with_update_mask and update_mask is None:
        raise ValueError(
            "with_update_mask=True but no update_mask argument was "
            "passed: the context-table freeze has no mask")
    if not with_update_mask and update_mask is not None:
        raise ValueError(
            "update_mask passed but the factory was built with "
            "with_update_mask=False: the freeze would be silently ignored")


def make_node2vec_train_step(config: Node2VecConfig, optimizer,
                             with_update_mask: bool = False):
    """step(params, opt_state, b1, b2, mask, neg_ids[, update_mask]) ->
    (params, opt_state, loss, aux): one SGD step over the whole tables.
    ``update_mask`` [num_nodes] (1 = a trainable context row) is a
    runtime argument, multiplied into the context table's gradient."""

    def step(params, opt_state, b1, b2, mask, neg_ids, update_mask=None):
        _check_update_mask(with_update_mask, update_mask)
        opt_state.zero_grad(set_to_none=True)
        loss, aux = node2vec_loss(params, b1, b2, mask, neg_ids, config)
        loss.backward()
        if with_update_mask:
            mask_context_gradients(params, update_mask)
        optimizer.update(opt_state, params)
        return params, opt_state, loss.detach(), aux

    return step


def make_node2vec_chunk_runner(config: Node2VecConfig, optimizer,
                               batch_size: int, num_nodes: int,
                               with_update_mask: bool = False):
    """runner(params, opt_state, shadow_mrr, pairs_perm, neg_ids,
    start_step, n_steps[, update_mask]) -> (params, opt_state,
    shadow_mrr, last_loss, last_mrr).

    Runs steps ``start_step .. start_step + n_steps - 1`` of an epoch
    whose shuffled pair stream ``pairs_perm`` [P, 2], padded with the
    dummy id ``num_nodes``, lives on the device: step ``start_step + j``
    takes pairs ``pairs_perm[i*B:(i+1)*B]`` (i its index in the epoch),
    masks them with ``b1 != num_nodes`` and takes the negatives
    ``neg_ids[j]`` ([n_steps, n_neg] on the device). The tables have
    num_nodes + 1 rows, so the dummy's rows exist and are masked out of
    the loss. The train-MRR EMA ``shadow_mrr`` (a device scalar, < 0
    until set) is carried through the steps; nothing is read back.
    """
    step_fn = make_node2vec_train_step(config, optimizer, with_update_mask)

    def runner(params, opt_state, shadow_mrr, pairs_perm, neg_ids,
               start_step: int, n_steps: int, update_mask=None):
        _check_update_mask(with_update_mask, update_mask)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        for j in range(n_steps):
            i = start_step + j
            pair = pairs_perm[i * batch_size:(i + 1) * batch_size]
            b1, b2 = pair[:, 0], pair[:, 1]
            mask = (b1 != num_nodes).float()
            params, opt_state, loss, aux = step_fn(
                params, opt_state, b1, b2, mask, neg_ids[j], update_mask)
            shadow_mrr = mrr_ema(shadow_mrr, aux["mrr"])
        return params, opt_state, shadow_mrr, loss, aux["mrr"]

    return runner


def make_dp_supervised_chunk_runner(sup_config: SupervisedConfig, optimizer,
                                    grid, batch_size: int):
    """--data_shards M: the chunk runner of ``make_supervised_chunk_runner``
    (the same call and return layout, so the trainer swaps them 1:1) over
    a grid of one graph shard and M data slices: tables and params
    replicated, rank ``me`` takes rows ``me*B/M .. (me+1)*B/M`` of each
    step's batch, its masked loss sum is normalised by the world's mask
    sum, and the gradients and the last step's loss are summed over the
    world. The
    decay term, replicated work, is divided by M. The inner hop's
    dropout is keyed with (``drop_seed`` folded with ``me``, i);
    ``generator`` should be the rank's own. ``last_logits`` and
    ``last_ids`` are this rank's rows."""
    from graphsage_tpu_torch.parallel.graph_sharded import (
        _check_batch_divisible,
        _decay_term,
    )

    config = sup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "id stream")
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total

    def runner(params, opt_state, generator, features, adj, ids_perm,
               labels_table, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        seed = fold_seed(drop_seed, grid.me)
        for i in range(start_step, start_step + n_steps):
            lo = i * batch_size + grid.me * local_b
            ids = ids_perm[lo:lo + local_b]
            labels = labels_table.index_select(0, ids)
            mask = (ids != num_nodes).float()
            mask_sum = mask.sum()
            dist.all_reduce(mask_sum)
            opt_state.zero_grad(set_to_none=True)
            logits = supervised_logits(
                params, features, adj, ids, sup_config, generator=generator,
                deterministic=False, drop_key=(seed, i))
            per_node = per_node_loss(logits, labels, sup_config)
            loss = ((per_node * mask).sum() / torch.clamp(mask_sum, min=1.0)
                    + _decay_term(params, config, sup_config.weight_decay,
                                  grid.total, head=True))
            loss.backward()
            all_reduce_grads(params, grid)
            optimizer.update(opt_state, params)
        loss = loss.detach()
        dist.all_reduce(loss)   # the last step's, read by the caller
        return params, opt_state, loss, logits.detach(), ids

    return runner


def make_tp_supervised_chunk_runner(sup_config: SupervisedConfig, optimizer,
                                    grid, batch_size: int):
    """--n_model_shards M (x --data_shards D): the chunk runner of
    ``make_supervised_chunk_runner`` (the same call and return layout)
    over a grid of D data slices of M model ranks, the JAX package's
    GSPMD runner over its ("data", "model") mesh. Each rank holds its
    model shard's column blocks of ``features`` and of the identity
    table and the matching rows of layer 0's contracting weights
    (``tensor.py``); rank (d, m) takes rows ``d*B/D .. (d+1)*B/D`` of
    each step's batch. Its masked loss sum is normalised by the data
    group's mask sum, the decay term (whole on every rank: a shard's
    squares are summed over the model group) is divided by D, and the
    gradients and the last step's loss are summed over the data group.
    The sampler and the dropouts draw alike on a model group's ranks:
    ``generator`` and the inner hop's dropout seed are folded with the
    data index only (``tensor.tp_seed``). ``last_logits`` and
    ``last_ids`` are this data slice's rows."""
    from graphsage_tpu_torch.models.supervised import weight_decay_term
    from graphsage_tpu_torch.parallel.tensor import ModelShard, tp_seed

    config = sup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "id stream")
    D = grid.data_size
    if batch_size % D:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"--data_shards {D}")
    local_b = batch_size // D
    shard = ModelShard.of(config, grid)

    def data_sum(t):
        if D > 1:
            dist.all_reduce(t, group=grid.data_group)
        return t

    def runner(params, opt_state, generator, features, adj, ids_perm,
               labels_table, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        seed = tp_seed(drop_seed, grid)
        for i in range(start_step, start_step + n_steps):
            lo = i * batch_size + grid.data_rank * local_b
            ids = ids_perm[lo:lo + local_b]
            labels = labels_table.index_select(0, ids)
            mask = (ids != num_nodes).float()
            mask_sum = data_sum(mask.sum())
            opt_state.zero_grad(set_to_none=True)
            logits = supervised_logits(
                params, features, adj, ids, sup_config, generator=generator,
                deterministic=False, drop_key=(seed, i), shard=shard)
            per_node = per_node_loss(logits, labels, sup_config)
            loss = (per_node * mask).sum() / torch.clamp(mask_sum, min=1.0)
            if sup_config.weight_decay > 0.0:
                loss = loss + weight_decay_term(params, sup_config,
                                                shard) / D
            loss.backward()
            all_reduce_grads(params, grid)
            optimizer.update(opt_state, params)
        return (params, opt_state, data_sum(loss.detach()), logits.detach(),
                ids)

    return runner


def make_dp_unsupervised_chunk_runner(unsup_config: UnsupervisedConfig,
                                      optimizer, grid, batch_size: int):
    """--data_shards M unsupervised: the chunk runner of
    ``make_unsupervised_chunk_runner`` (the same call and return layout)
    over a grid of one graph shard and M data slices: tables and params
    replicated, rank ``me`` takes pairs ``me*B/M .. (me+1)*B/M`` of each
    step's batch and every rank the step's one negative set
    ``neg_ids[i]``, as one device does. The per-edge losses are
    normalised by the world's mask count, the gradients summed over the
    world and the MRR is the exact global masked mean (its sums ride
    the gradient bucket), so under first_k it is the single-device
    runner's to the rounding of the sums' order (bit for bit at one
    rank). The decay term is divided by M; the inner hop's dropout is
    keyed with (``drop_seed`` folded with ``me``, i); ``generator``
    should be the rank's own."""
    from graphsage_tpu_torch.parallel.graph_sharded import (
        _unsup_chunk_runner,
    )

    config = unsup_config.sage

    def embed(params, features, adj, ids, generator, drop_key):
        return sage_embed(params, features, adj, ids, config,
                          generator=generator, deterministic=False,
                          drop_key=drop_key), None

    run = _unsup_chunk_runner(unsup_config, optimizer, grid, batch_size,
                              embed, rank_negatives=False)

    def runner(*args, **kwargs):
        return run(*args, **kwargs)[:5]

    return runner
