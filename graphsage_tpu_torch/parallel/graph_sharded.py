"""Graph sharding (the P2 path): row-sharded tables and the all-to-all
halo exchange, for graphs whose feature table outgrows one device.

The feature table, the padded adjacency and (with ``identity_dim > 0``)
the trainable identity table are row-sharded across the ranks of a graph
group (``distributed.Grid``); each rank takes its split of every batch,
and every frontier gather becomes a two-phase exchange:

  1. bucket the global row ids by owning shard (a stable sort, and each
     request's rank within its owner's bucket), a static capacity per
     destination; one ``all_to_all_single`` sends the request ids;
  2. the owners gather their local rows; a second ``all_to_all_single``
     sends them back, and the requester undoes the sort.

Requests beyond the capacity are dropped, return zero rows and are
counted. The replicated parameters' gradients are summed over the world
in one flattened bucket; the identity table's gradient reaches its owner
through the exchange's backward (the reverse all-to-all, then
``index_add_``), as JAX's autodiff transposes its ``all_to_all``.

At one shard the innermost hop's mean runs through the port's
gather-mean kernels (``ops/gather.py::fused_gather_mean``: K1, K2 with
dropout, K3 with ``dedup_gather``). At more shards it splits: the local
rows' share is a plain take, mask and mean off the local shard, the
remote share rides the exchange, and the two partial sums add.

The supervised runners, eval and sweep, and their unsupervised
counterparts (three towers in one ``sharded_sage_embed``, the
skip-gram loss, the MRR as the exact global masked mean) and the
sharded embed sweep share the exchange and the reductions above.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graphsage_tpu_torch.models.graphsage import (
    IDENTITY_DROP_TAG,
    KERNEL_DROP_TAG,
    aggregate_pyramid,
    l2_normalize,
    sage_decay_weights,
)
from graphsage_tpu_torch.models.supervised import (
    head_params,
    per_node_loss,
    supervised_predict,
)
from graphsage_tpu_torch.nn import prediction
from graphsage_tpu_torch.nn.dense import apply_dense
from graphsage_tpu_torch.nn.sampler import sample_from_rows
from graphsage_tpu_torch.ops.gather import fused_gather_mean
from graphsage_tpu_torch.ops.philox import philox_dropout
from graphsage_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    fold_seed,
    host_array,
)
from graphsage_tpu_torch.parallel.dp import _require_num_nodes, mrr_ema

# Philox tags of the split mean's two partial sums (the identity columns
# keep IDENTITY_DROP_TAG, a one-shard mean K2's KERNEL_DROP_TAG)
LOCAL_DROP_TAG = KERNEL_DROP_TAG
REMOTE_DROP_TAG = KERNEL_DROP_TAG + 1

# Frontiers of at most this many requests get an exact capacity (= m):
# the send buffer is D*m ids, affordable for small gathers, and nothing
# can overflow there.
EXACT_CAPACITY_MAX = 4096


# ------------------------------------------------------------- layouts

def shard_rows(table, n_shards: int, layout: str = "strided"):
    """Pad a [N, ...] table (NumPy or torch) with zero rows to a multiple
    of ``n_shards`` and order its rows for a contiguous split: (device
    layout, shard_size).

    - ``"strided"`` (default): shard d owns global rows ``d::n_shards``
      (owner = id % D). Ids ordered by degree would park every hub on
      shard 0 under contiguous ownership; striding spreads them, so the
      exchange's capacity sizes to the balanced share.
    - ``"block"``: shard d owns rows [d*ss, (d+1)*ss).

    Contiguous slice d of the result is shard d's table.
    """
    n = table.shape[0]
    shard_size = -(-n // n_shards)
    pad = shard_size * n_shards - n
    if pad:
        if isinstance(table, np.ndarray):
            table = np.pad(table, [(0, pad)] + [(0, 0)] * (table.ndim - 1))
        else:
            table = torch.cat([table, table.new_zeros(
                (pad,) + tuple(table.shape[1:]))])
    if layout == "strided" and n_shards > 1:
        table = _row_perm_apply(table, n_shards, to_canonical=False)
    return table, shard_size


def _row_perm_apply(table, n_shards: int, to_canonical: bool):
    """Reorder a padded [D*ss, ...] table between the strided device
    layout (device[d*ss+r] = canonical[r*D+d]) and canonical id order."""
    ss = table.shape[0] // n_shards
    tail = tuple(table.shape[1:])
    if to_canonical:
        shaped = table.reshape((n_shards, ss) + tail)
    else:
        shaped = table.reshape((ss, n_shards) + tail)
    if isinstance(table, np.ndarray):
        return np.ascontiguousarray(shaped.swapaxes(0, 1)).reshape(
            table.shape)
    return shaped.transpose(0, 1).reshape(table.shape)


def device_rows_to_node_ids(device_rows, n_shards: int, shard_size: int,
                            layout: str = "strided"):
    """Node ids held at the given device-layout rows (the inverse of
    ``shard_rows``' order): strided device row d*ss + r holds node
    r*D + d."""
    if layout == "strided" and n_shards > 1:
        return ((device_rows % shard_size) * n_shards
                + device_rows // shard_size)
    return device_rows


def local_shard(table: np.ndarray, n_shards: int, index: int,
                layout: str = "strided") -> np.ndarray:
    """Shard ``index`` of ``table`` (rows past the end are zeros), read
    without building the whole device layout."""
    shard_size = -(-table.shape[0] // n_shards)
    rows = np.arange(index * shard_size, (index + 1) * shard_size)
    ids = device_rows_to_node_ids(rows, n_shards, shard_size, layout)
    out = np.zeros((shard_size,) + table.shape[1:], dtype=table.dtype)
    real = ids < table.shape[0]
    out[real] = table[ids[real]]
    return out


def gather_canonical(local: torch.Tensor, grid, n_rows: int,
                     layout: str) -> torch.Tensor:
    """The table row-sharded over ``grid``'s graph group, whole and in
    canonical id order (its first ``n_rows`` rows), as a CPU tensor on
    every rank of the group: a collective call."""
    table = host_array(local, grid.graph_group)
    if layout == "strided" and grid.graph_size > 1:
        table = _row_perm_apply(table, grid.graph_size, to_canonical=True)
    return torch.from_numpy(np.ascontiguousarray(table[:n_rows]))


def _map_embeds(tree, fn):
    """``fn`` applied to every leaf whose key is ``embeds`` in a dict of
    tensors, or in the nested dicts of an optimizer state."""
    if isinstance(tree, dict):
        return {k: (fn(v) if k == "embeds" and not isinstance(v, dict)
                    else _map_embeds(v, fn)) for k, v in tree.items()}
    return tree


def embeds_to_canonical(tree, n_shards: int, layout: str):
    """Every ``embeds`` leaf (the identity table and its Adam moments)
    from the device layout to canonical id order. Checkpoints store this
    order, so a run resumes under another ``--graph_shards`` or
    ``--shard_layout``, or on one device."""
    if layout != "strided" or n_shards <= 1:
        return tree
    return _map_embeds(tree, lambda x: _row_perm_apply(x, n_shards, True))


def embeds_to_device_layout(tree, n_shards: int, layout: str):
    """Inverse of ``embeds_to_canonical``."""
    if layout != "strided" or n_shards <= 1:
        return tree
    return _map_embeds(tree, lambda x: _row_perm_apply(x, n_shards, False))


# ------------------------------------------------------------ capacity

def _capacity(m: int, n_shards: int, factor: float) -> int:
    """Static per-destination budget: the balanced share times the
    safety factor, clipped to m (always exact). Small frontiers are
    exact."""
    if m <= EXACT_CAPACITY_MAX:
        return m
    return int(min(m, max(1, -(-m // n_shards) * factor)))


def suggest_capacity_factor(adj, n_shards: int, margin: float = 1.5,
                            layout: str = "strided") -> float:
    """The per-destination safety factor from the adjacency's ownership
    histogram (the stationary distribution of one-hop requests) times
    ``margin``, in [1, n_shards]. ``layout`` must match the tables'."""
    adj = np.asarray(adj)
    flat = adj.ravel()
    if layout == "strided":
        counts = np.bincount(flat % n_shards, minlength=n_shards)
    else:
        shard_size = -(-adj.shape[0] // n_shards)
        counts = np.bincount(flat // shard_size, minlength=n_shards)
    mean = max(counts.mean(), 1.0)
    factor = float(counts.max()) / mean * margin
    return float(min(n_shards, max(1.0, factor)))


# ------------------------------------------------------------ exchange

class _ServeRows(torch.autograd.Function):
    """The owner's half of the exchange: gather the requested local rows
    and all-to-all them back. Its backward sends each row's gradient
    home by the reverse all-to-all and adds it into the local rows."""

    @staticmethod
    def forward(ctx, local, recv, group):
        ctx.save_for_backward(recv)
        ctx.group, ctx.shape = group, local.shape
        rows = local.index_select(0, recv)
        resp = torch.empty_like(rows)
        dist.all_to_all_single(resp, rows, group=group)
        return resp

    @staticmethod
    def backward(ctx, grad_resp):
        (recv,) = ctx.saved_tensors
        grad_rows = torch.empty_like(grad_resp)
        dist.all_to_all_single(grad_rows, grad_resp.contiguous(),
                               group=ctx.group)
        grad_local = grad_rows.new_zeros(ctx.shape).index_add_(
            0, recv, grad_rows)
        return grad_local, None, None


def _owner_of(idx, n_shards: int, shard_size: int, layout: str):
    """(owning shard, row in the owner's shard) of global ids."""
    if layout == "strided":
        return idx % n_shards, idx // n_shards
    return idx // shard_size, idx % shard_size


class PendingGather:
    """An exchange whose request all-to-all is in flight; ``wait()``
    serves it and returns (rows [m, ...], dropped)."""

    def __init__(self, rows=None, dropped=None, **plan):
        self._rows, self._dropped, self._plan = rows, dropped, plan

    def wait(self):
        if self._rows is not None:
            return self._rows, self._dropped
        p = self._plan
        if p["work"] is not None:
            p["work"].wait()
        local, D, cap = p["local"], p["D"], p["capacity"]
        tail = tuple(local.shape[1:])
        bshape = (-1,) + (1,) * len(tail)
        resp = _ServeRows.apply(local, p["recv"], p["group"])
        # resp[o*cap + r] = the row of my r-th request to owner o
        slot = (p["sorted_owner"].clamp(0, D - 1) * cap
                + p["rank"].clamp(0, cap - 1))
        gathered = resp.index_select(0, slot)
        gathered = torch.where(p["valid"].view(bshape), gathered, 0)
        out = gathered.index_select(0, p["inv"])
        if p["local_rows"] is not None:
            out = torch.where(p["is_local"].view(bshape), p["local_rows"],
                              out)
        self._rows, self._plan = out, None
        return out, self._dropped


def start_exchange(local: torch.Tensor, idx: torch.Tensor, group,
                   capacity: int, split_local: bool = True,
                   layout: str = "strided", remote_only: bool = False,
                   async_op: bool = False) -> PendingGather:
    """Start the gather of global rows ``idx`` [m] from a table row-sharded
    over ``group``; this rank holds ``local`` [shard_size, ...], built by
    ``shard_rows`` with the same ``layout``.

    ``capacity``: the static per-destination request budget; requests
    beyond it are dropped (zero rows) and counted in ``dropped``, the
    later ones in original order within each owner, as in the JAX
    package. ``split_local``: requests for this rank's own rows take a
    direct local gather and use no budget (the same bits as through the
    exchange). ``remote_only``: those requests return zero rows, for
    callers that serve the local share themselves. ``async_op``: the
    request all-to-all is started without waiting; ``wait()`` is required
    before the rows are read.
    """
    D = dist.get_world_size(group)
    me = dist.get_rank(group)
    shard_size, m = local.shape[0], idx.shape[0]
    tail = tuple(local.shape[1:])
    bshape = (m,) + (1,) * len(tail)
    split_local = split_local or remote_only
    if split_local and D == 1:   # every row is local: a plain take
        rows = (local.new_zeros((m,) + tail) if remote_only
                else local.index_select(0, idx))
        return PendingGather(rows=rows, dropped=torch.zeros(
            (), dtype=torch.int32, device=idx.device))
    idx = idx.long()
    owner, local_of = _owner_of(idx, D, shard_size, layout)

    local_rows = is_local = None
    if split_local:
        is_local = owner == me
        if not remote_only:
            local_rows = local.index_select(
                0, torch.where(is_local, local_of, 0))
            local_rows = torch.where(is_local.view(bshape), local_rows, 0)
        # local requests go to sentinel segment D: no budget, no send
        owner = torch.where(is_local, D, owner)

    order = torch.argsort(owner, stable=True)
    sorted_owner = owner.index_select(0, order)
    counts = torch.zeros(D + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, owner, torch.ones_like(owner))
    starts = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(m, device=idx.device)
            - starts.index_select(0, sorted_owner))
    remote = sorted_owner < D
    valid = (rank < capacity) & remote
    # [D, capacity] offsets into each owner's shard, plus one spare row
    # that takes every dropped or local request and is sliced off
    send = torch.zeros((D + 1) * capacity, dtype=torch.int32,
                       device=idx.device)
    slot = torch.where(valid, sorted_owner * capacity + rank, D * capacity)
    send.scatter_(0, slot, local_of.index_select(0, order).int())
    send = send[:D * capacity]
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group,
                                  async_op=async_op)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(m, device=idx.device))
    dropped = (~valid & remote).sum().to(torch.int32)
    return PendingGather(local=local, group=group, D=D, capacity=capacity,
                         send=send, recv=recv, work=work,
                         sorted_owner=sorted_owner, rank=rank, valid=valid,
                         inv=inv, is_local=is_local, local_rows=local_rows,
                         dropped=dropped)


def exchange_gather(local: torch.Tensor, idx: torch.Tensor, group,
                    capacity: int, return_dropped: bool = False,
                    split_local: bool = True, layout: str = "strided",
                    remote_only: bool = False):
    """Rows [m, ...] of global ids ``idx`` from a table row-sharded over
    ``group`` (``start_exchange``, waited for), and with
    ``return_dropped`` the int32 count of this rank's requests that
    overflowed the capacity."""
    rows, dropped = start_exchange(
        local, idx, group, capacity, split_local=split_local, layout=layout,
        remote_only=remote_only).wait()
    return (rows, dropped) if return_dropped else rows


# ------------------------------------------------------- the model path

def sharded_sage_embed(params, feat_local, adj_local, ids, config,
                       group, capacity_factor: float = 4.0,
                       generator=None, deterministic: bool = True,
                       drop_key: tuple[int, int] | None = None,
                       return_stats: bool = False, halo: str = "overlap"):
    """``sage_embed`` over tables row-sharded across ``group``: every
    frontier expansion and feature gather rides the exchange, the
    aggregation is local. ``params["embeds"]`` is this rank's shard of
    the identity table. With ``return_stats`` also the count of this
    rank's dropped requests.

    ``halo`` picks the exchange schedule; the outputs are bit-identical:
    - ``"overlap"``: frontier k's feature exchange is started (async)
      before the hop-k+1 adjacency exchange and waited for before the
      aggregation; own-shard rows skip the collectives (``split_local``);
    - ``"blocking"``: every expansion, then every feature gather, each
      row through the all-to-all.
    The fused innermost hop follows ``config.fused_gather`` under
    either schedule. ``drop_key`` = (seed, step) keys the inner hop's
    Philox masks; ``generator`` drives the sampler and the plain
    dropouts (give each rank its own).
    """
    D = dist.get_world_size(group)
    me = dist.get_rank(group)
    fanouts = config.fanouts
    n_layers = len(fanouts)
    overlap = halo == "overlap"
    layout = config.shard_layout
    has_features = feat_local is not None and config.feature_dim > 0
    fuse_inner = (config.fused_gather and config.aggregator in ("mean", "gcn")
                  and has_features)
    inner_drop = (config.dropout if not deterministic and config.dropout > 0
                  else 0.0)
    if inner_drop > 0.0 and fuse_inner and drop_key is None:
        raise ValueError("training the fused hop with dropout needs "
                         "drop_key=(seed, step)")

    def start_level(s):
        """Identity and feature rows of one frontier, in flight."""
        cap = _capacity(s.shape[0], D, capacity_factor)
        parts = []
        if config.identity_dim > 0:
            parts.append(start_exchange(params["embeds"], s, group, cap,
                                        split_local=overlap, layout=layout,
                                        async_op=overlap))
        if has_features:
            parts.append(start_exchange(feat_local, s, group, cap,
                                        split_local=overlap, layout=layout,
                                        async_op=overlap))
        return parts

    def finish_level(parts):
        rows, dropped = zip(*(p.wait() for p in parts))
        if has_features:
            rows = rows[:-1] + (rows[-1][:, :config.feature_dim],)
        return (rows[0] if len(rows) == 1 else torch.cat(rows, dim=1),
                sum(dropped))

    samples = [ids]
    pending = [start_level(ids)] if overlap else []
    dropped = torch.zeros((), dtype=torch.int32, device=ids.device)
    for k in range(n_layers):
        t = n_layers - k - 1
        m = samples[k].shape[0]
        adj_rows, d = exchange_gather(
            adj_local, samples[k], group, _capacity(m, D, capacity_factor),
            return_dropped=True, split_local=overlap, layout=layout)
        dropped = dropped + d
        nxt = sample_from_rows(generator, adj_rows, fanouts[t],
                               mode=config.sampler_mode)
        samples.append(nxt.reshape(-1))
        if overlap and not (fuse_inner and k == n_layers - 1):
            pending.append(start_level(samples[-1]))
    if not overlap:
        inner = samples[:-1] if fuse_inner else samples
        pending = [start_level(s) for s in inner]
    hidden = []
    for parts in pending:
        h, d = finish_level(parts)
        hidden.append(h)
        dropped = dropped + d

    last_mean = None
    if fuse_inner:
        hidden.append(None)   # served by the mean below
        S0 = fanouts[0]
        idx2 = samples[-1].reshape(-1, S0)
        seed, step = drop_key if inner_drop > 0.0 else (None, 0)
        if D == 1:
            last_mean = fused_gather_mean(
                feat_local, idx2, drop_rate=inner_drop, seed=seed,
                offset=(step, KERNEL_DROP_TAG) if inner_drop > 0 else None,
                dedup=config.dedup_gather)
        else:
            last_mean, d = _split_mean(feat_local, samples[-1], S0, group,
                                       me, D, layout, capacity_factor,
                                       inner_drop, seed, step)
            dropped = dropped + d
        last_mean = last_mean[:, :config.feature_dim]
        if config.identity_dim > 0:
            # the identity columns of the same rows take the
            # differentiable exchange; their mean splits per column group
            id_rows, d = exchange_gather(
                params["embeds"], samples[-1], group,
                _capacity(samples[-1].shape[0], D, capacity_factor),
                return_dropped=True, split_local=overlap, layout=layout)
            dropped = dropped + d
            if inner_drop > 0.0:
                id_rows = philox_dropout(id_rows, inner_drop, seed, step,
                                         IDENTITY_DROP_TAG)
            id_mean = id_rows.view(-1, S0, config.identity_dim).mean(dim=1)
            last_mean = torch.cat([id_mean, last_mean], dim=1)
    out = aggregate_pyramid(
        params, hidden, ids.shape[0], config,
        generator=None if deterministic else generator,
        deterministic=deterministic, last_hop_neigh_mean=last_mean)
    return (out, dropped) if return_stats else out


def _split_mean(feat_local, flat, S0: int, group, me: int, D: int,
                layout: str, capacity_factor: float, drop_rate: float,
                seed, step: int):
    """The innermost hop's [rows, F] f32 mean at D > 1: the local rows'
    share as a take, mask and mean off the local shard, the remote share
    through the exchange (``remote_only``), the two partial sums added.
    Not bit-identical to the unsplit mean (the f32 sums reorder). With
    dropout each share is masked per element by its own Philox stream."""
    owner, local_idx = _owner_of(flat.long(), D, feat_local.shape[0], layout)
    is_local = (owner == me).view(-1, S0, 1)
    local_rows = feat_local.index_select(
        0, torch.where(owner == me, local_idx, 0)).float()
    remote_rows, dropped = exchange_gather(
        feat_local, flat, group, _capacity(flat.shape[0], D, capacity_factor),
        return_dropped=True, layout=layout, remote_only=True)
    remote_rows = remote_rows.float()
    if drop_rate > 0.0:
        local_rows = philox_dropout(local_rows, drop_rate, seed, step,
                                    LOCAL_DROP_TAG)
        # local positions are zero rows here, so their mask is moot
        remote_rows = philox_dropout(remote_rows, drop_rate, seed, step,
                                     REMOTE_DROP_TAG)
    F = feat_local.shape[1]
    local_sum = (local_rows.view(-1, S0, F) * is_local.float()).sum(
        dim=1) * (1.0 / S0)
    remote_sum = remote_rows.view(-1, S0, F).sum(dim=1) * (1.0 / S0)
    return local_sum + remote_sum, dropped


# --------------------------------------------- losses and reductions

def _check_batch_divisible(grid, batch_size: int) -> None:
    """Every runner slices a batch into ``batch_size // total`` rows a
    rank; a remainder would silently go unevaluated."""
    if batch_size % grid.total != 0:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the total shard "
            f"count {grid.total} (graph={grid.graph_size} x "
            f"data={grid.data_size})")


def _graph_major_me(grid) -> int:
    """This rank's slice of a batch split over the whole grid, graph-major
    (g * M + d): each graph rank's slice nests over the data slices, so
    every row keeps the graph rank it has on a 1 x D grid. The runners
    and the row-output sweeps split data-major (``grid.me``, d * D + g,
    the order in which the ranks' rows stack)."""
    return grid.graph_rank * grid.data_size + grid.data_rank


def _sup_per_node_xent(sup_config, params, feat_local, adj_local, ids,
                       labels, group, capacity_factor, generator,
                       deterministic, drop_key=None):
    """embed -> l2-normalise -> dense head (its input dropped out when
    training) -> per-node loss, shared by every sharded supervised path:
    (per_node [b], logits [b, C], dropped)."""
    emb, dropped = sharded_sage_embed(
        params, feat_local, adj_local, ids, sup_config.sage, group,
        capacity_factor, generator=generator, deterministic=deterministic,
        drop_key=drop_key, return_stats=True)
    logits = apply_dense(
        head_params(params), l2_normalize(emb, dim=1), act=None,
        dropout_rate=sup_config.sage.dropout, generator=generator,
        deterministic=deterministic)
    return per_node_loss(logits, labels, sup_config), logits, dropped


def _decay_sum(params, sage_config, weight_decay: float,
               head: bool = False):
    """The single-device loss's weight-decay term, undivided (the sharded
    evals add it once to their summed loss)."""
    if weight_decay <= 0.0:
        return 0.0
    decayed = sage_decay_weights(params, sage_config)
    if head:
        decayed = decayed + [params["head.w"], params["head.b"]]
    return weight_decay * sum(0.5 * (w * w).sum() for w in decayed)


def _decay_term(params, sage_config, weight_decay: float, total: int,
                head: bool = False):
    """The training losses' decay term: replicated work, divided by the
    total shard count so that the summed loss and gradients give the
    single-device value."""
    if weight_decay <= 0.0:
        return 0.0
    return _decay_sum(params, sage_config, weight_decay, head) / total


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def _unsup_pair_metrics(out1, out2, neg, mask, unsup_config):
    """(raw skip-gram loss, [sum of rr * mask, sum of mask]) of the three
    l2-normalised towers: the body of every sharded unsupervised path.
    The affinities are ``prediction.edge_pred_scores``' (one product for
    positive and negative scores), as on one device; the MRR's masked
    sums, not their mean, leave the rank (``_global_masked_mrr``)."""
    aff, neg_aff = prediction.edge_pred_scores(out1, out2, neg)
    raw = prediction.pair_loss(aff, neg_aff, unsup_config.loss_fn, mask,
                               unsup_config.neg_sample_weights)
    ranks, _ = prediction.mrr_and_ranks(aff.detach(), neg_aff.detach(),
                                        mask)
    return raw, torch.stack([(1.0 / ranks.float() * mask).sum(), mask.sum()])


def _masked_mean(sums: torch.Tensor) -> torch.Tensor:
    """sum(rr * mask) / max(sum(mask), 1) of a [2] tensor of the sums:
    ``mrr_and_ranks``' masked mean, the same division."""
    return sums[0] / torch.clamp(sums[1], min=1.0)


def _global_masked_mrr(sums: torch.Tensor, group=None) -> torch.Tensor:
    """The exact global masked-mean MRR from each rank's [sum of rr *
    mask, sum of mask]: both summed over ``group``, then divided. The
    ranks' MRRs are not averaged: a rank whose slice of a dummy-padded
    tail batch is all padding (MRR 0 of count 0) would pull the mean
    down. The JAX package recovers the sums as mrr * count; here they
    come straight from the ranks. The runners and evaluations reduce the
    same two sums inside a collective they make anyway (the gradient
    bucket, the loss's sums)."""
    return _masked_mean(_all_reduce(sums.clone(), group))


def _towers(out, b: int):
    """The l2-normalised (batch1, batch2, negatives) rows of one
    ``[b1; b2; neg]`` forward."""
    return (l2_normalize(out[:b], 1), l2_normalize(out[b:2 * b], 1),
            l2_normalize(out[2 * b:], 1))


# ------------------------------------------------------------- runners

def make_sharded_supervised_chunk_runner(sup_config, optimizer, grid,
                                         batch_size: int,
                                         capacity_factor: float = 4.0):
    """runner(params, opt_state, generator, feat_local, adj_local,
    ids_perm, labels_table, start_step, n_steps, drop_seed=0) ->
    (params, opt_state, last_loss, last_logits, last_ids, dropped): the
    data-parallel runner's outputs (``parallel/dp.py``) and the dropped
    count.

    Steps ``start_step .. start_step + n_steps - 1`` of an epoch whose
    padded, shuffled global id stream ``ids_perm`` (the same on every
    rank) lives on the device: step i's batch is
    ``ids_perm[i*B:(i+1)*B]``, and this rank takes rows
    ``me*B/total .. (me+1)*B/total`` of it (``grid.me``, data-major).
    The loss is normalised by the world's mask sum; the replicated
    gradients are summed over the world, the identity shard's over the
    data group only (the exchange's backward already summed it within
    the graph group). ``params["embeds"]`` and its Adam moments are this
    rank's shard. The step's inner-hop dropout is keyed with
    (``drop_seed`` folded with ``grid.me``, i). ``last_logits`` and
    ``last_ids`` are this rank's rows; the last step's loss and the
    chunk's dropped count are summed over the world once, at the end of
    the chunk, and stay on the device, so the host syncs only where the
    caller reads them.
    """
    config = sup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "id stream")
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total

    def runner(params, opt_state, generator, feat_local, adj_local,
               ids_perm, labels_table, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        seed = fold_seed(drop_seed, grid.me)
        dropped_tot = torch.zeros((), dtype=torch.int32,
                                  device=ids_perm.device)
        for i in range(start_step, start_step + n_steps):
            lo = i * batch_size + grid.me * local_b
            ids = ids_perm[lo:lo + local_b]
            labels = labels_table.index_select(0, ids)
            mask = (ids != num_nodes).float()
            global_mask_sum = torch.clamp(_all_reduce(mask.sum()), min=1.0)
            opt_state.zero_grad(set_to_none=True)
            per_node, logits, dropped = _sup_per_node_xent(
                sup_config, params, feat_local, adj_local, ids, labels,
                grid.graph_group, capacity_factor, generator,
                deterministic=config.dropout == 0.0, drop_key=(seed, i))
            loss = (per_node * mask).sum() / global_mask_sum
            loss = loss + _decay_term(params, config, sup_config.weight_decay,
                                      grid.total, head=True)
            loss.backward()
            all_reduce_grads(params, grid)
            optimizer.update(opt_state, params)
            dropped_tot = dropped_tot + dropped
        return (params, opt_state, _all_reduce(loss.detach()),
                logits.detach(), ids, _all_reduce(dropped_tot))

    return runner


def make_sharded_supervised_eval(sup_config, grid,
                                 capacity_factor: float = 4.0):
    """eval_fn(params, feat_local, adj_local, ids, labels, mask,
    generator=None) -> (loss, this rank's preds, dropped) on one batch,
    split over the graph group (each data slice evaluates it whole); the
    loss carries the single-device eval's decay term, so val losses
    compare across shard counts. The batch must split evenly over the
    graph group."""
    config = sup_config.sage
    D, g, group = grid.graph_size, grid.graph_rank, grid.graph_group

    @torch.inference_mode()
    def eval_fn(params, feat_local, adj_local, ids, labels, mask,
                generator=None):
        lb = ids.shape[0] // D
        sl = slice(g * lb, (g + 1) * lb)
        per_node, logits, dropped = _sup_per_node_xent(
            sup_config, params, feat_local, adj_local, ids[sl], labels[sl],
            group, capacity_factor, generator, deterministic=True)
        denom = torch.clamp(_all_reduce(mask[sl].sum(), group), min=1.0)
        loss = _all_reduce((per_node * mask[sl]).sum(), group) / denom
        loss = loss + _decay_sum(params, config, sup_config.weight_decay,
                                 head=True)
        return (loss, supervised_predict(logits, sup_config),
                _all_reduce(dropped, group))

    return eval_fn


def make_sharded_supervised_eval_sweep(sup_config, grid, batch_size: int,
                                       capacity_factor: float = 4.0):
    """sweep(params, feat_local, adj_local, ids_all, labels_table,
    generator=None) -> (per-batch losses [n_b], this rank's preds
    [n_b * B/total, C], dropped), all on the device.

    ``ids_all`` is the padded global id stream (the same on every rank);
    each batch splits over the whole grid, data-major as the chunk
    runner's. ``reassemble_sharded_rows`` of the ranks' stacked preds
    (``distributed.host_array``) gives the stream's order."""
    config = sup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "id stream")
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total

    @torch.inference_mode()
    def sweep(params, feat_local, adj_local, ids_all, labels_table,
              generator=None):
        n_b = ids_all.shape[0] // batch_size
        device = ids_all.device
        losses = torch.zeros(n_b, device=device)
        preds = torch.zeros(n_b * local_b, sup_config.num_classes,
                            device=device)
        dropped_tot = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(n_b):
            lo = i * batch_size + grid.me * local_b
            ids = ids_all[lo:lo + local_b]
            labels = labels_table.index_select(0, ids)
            mask = (ids != num_nodes).float()
            per_node, logits, dropped = _sup_per_node_xent(
                sup_config, params, feat_local, adj_local, ids, labels,
                grid.graph_group, capacity_factor, generator,
                deterministic=True)
            denom = torch.clamp(_all_reduce(mask.sum()), min=1.0)
            loss = _all_reduce((per_node * mask).sum()) / denom
            losses[i] = loss + _decay_sum(params, config,
                                          sup_config.weight_decay, head=True)
            preds[i * local_b:(i + 1) * local_b] = supervised_predict(
                logits, sup_config)
            dropped_tot += dropped
        return losses, preds, _all_reduce(dropped_tot)

    return sweep


# ------------------------------------------------ unsupervised runners

def _unsup_chunk_runner(unsup_config, optimizer, grid, batch_size: int,
                        embed, rank_negatives: bool):
    """The step loop of the sharded and the data-parallel unsupervised
    runners; ``embed(params, features, adj, ids, generator, drop_key)``
    -> (raw embeddings, dropped count or None) is theirs.
    ``rank_negatives``: step i takes ``neg_ids[i, grid.me]`` (each rank
    its own set), else ``neg_ids[i]`` (one set for every rank). Returns
    the runner, whose sixth output is this rank's dropped count over the
    chunk, not yet reduced."""
    config = unsup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "pair stream")
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total

    def runner(params, opt_state, shadow, generator, features, adj,
               pairs_perm, neg_ids, start_step: int, n_steps: int,
               drop_seed: int = 0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        seed = fold_seed(drop_seed, grid.me)
        dropped_tot = torch.zeros((), dtype=torch.int32,
                                  device=pairs_perm.device)
        for i in range(start_step, start_step + n_steps):
            lo = i * batch_size + grid.me * local_b
            pair = pairs_perm[lo:lo + local_b]
            b1, b2 = pair[:, 0], pair[:, 1]
            mask = (b1 != num_nodes).float()
            global_mask_sum = torch.clamp(_all_reduce(mask.sum()), min=1.0)
            neg = neg_ids[i, grid.me] if rank_negatives else neg_ids[i]
            opt_state.zero_grad(set_to_none=True)
            out, dropped = embed(params, features, adj,
                                 torch.cat([b1, b2, neg]), generator,
                                 (seed, i))
            raw, sums = _unsup_pair_metrics(*_towers(out, local_b), mask,
                                            unsup_config)
            loss = raw / global_mask_sum + _decay_term(
                params, config, unsup_config.weight_decay, grid.total)
            loss.backward()
            # the MRR's sums ride the gradient bucket: two collectives a
            # step, the mask sum and the bucket
            mrr = _masked_mean(all_reduce_grads(params, grid, extra=sums))
            optimizer.update(opt_state, params)
            shadow = mrr_ema(shadow, mrr)
            if dropped is not None:
                dropped_tot = dropped_tot + dropped
        return (params, opt_state, shadow, _all_reduce(loss.detach()), mrr,
                dropped_tot)

    return runner


def make_sharded_unsupervised_chunk_runner(unsup_config, optimizer, grid,
                                           batch_size: int,
                                           capacity_factor: float = 4.0):
    """runner(params, opt_state, shadow, generator, feat_local, adj_local,
    pairs_perm, neg_ids, start_step, n_steps, drop_seed=0) -> (params,
    opt_state, shadow, last_loss, last_mrr, dropped).

    Steps ``start_step .. start_step + n_steps - 1`` of an epoch whose
    padded, shuffled pair stream ``pairs_perm`` [P, 2] (the same on
    every rank) lives on the device: step i's batch is
    ``pairs_perm[i*B:(i+1)*B]``, this rank takes rows ``me*B/total ..
    (me+1)*B/total`` of it (``grid.me``, data-major) and its own
    negatives ``neg_ids[i, me]`` (``neg_ids`` [steps, total, n_neg],
    the JAX package's ``fold_in(step_rng, me)``; at one rank the
    single-device runner's draw). Its three towers run as one
    ``sharded_sage_embed`` of ``[b1; b2; neg]``, one exchange per level.
    The loss is normalised by the world's mask sum plus the decay term
    over the world size; the replicated gradients are summed over the
    world, the identity shard's over the data group only. The MRR is
    the world's exact masked mean and feeds the train-MRR EMA
    ``shadow`` on the device every step. The inner hop's dropout is
    keyed with (``drop_seed`` folded with ``grid.me``, i). The last
    step's loss and the chunk's dropped count are summed over the world
    once, at the end of the chunk; nothing is read back."""
    config = unsup_config.sage

    def embed(params, feat_local, adj_local, ids, generator, drop_key):
        return sharded_sage_embed(
            params, feat_local, adj_local, ids, config, grid.graph_group,
            capacity_factor, generator=generator,
            deterministic=config.dropout == 0.0, drop_key=drop_key,
            return_stats=True)

    run = _unsup_chunk_runner(unsup_config, optimizer, grid, batch_size,
                              embed, rank_negatives=True)

    def runner(*args, **kwargs):
        out = run(*args, **kwargs)
        return out[:5] + (_all_reduce(out[5]),)

    return runner


def _unsup_batch_sums(unsup_config, params, feat_local, adj_local, b1, b2,
                      mask, neg, group, capacity_factor, generator):
    """One evaluation batch's [raw loss, sum of rr * mask, sum of mask]
    on this rank, and its dropped count: the three towers in one
    forward, no dropout."""
    out, dropped = sharded_sage_embed(
        params, feat_local, adj_local, torch.cat([b1, b2, neg]),
        unsup_config.sage, group, capacity_factor, generator=generator,
        deterministic=True, return_stats=True)
    raw, sums = _unsup_pair_metrics(*_towers(out, b1.shape[0]), mask,
                                    unsup_config)
    return torch.cat([raw.reshape(1), sums]), dropped


def _unsup_eval_values(unsup_config, params, total: torch.Tensor):
    """(loss, mrr) of a batch from its summed [raw, rr sum, count]: the
    single-device eval's arithmetic (its decay term added once), so that
    at one rank the values are its bits."""
    loss = total[0] / torch.clamp(total[2], min=1.0) + _decay_sum(
        params, unsup_config.sage, unsup_config.weight_decay)
    return loss, _masked_mean(total[1:])


def make_sharded_unsupervised_eval(unsup_config, grid,
                                   capacity_factor: float = 4.0):
    """eval_fn(params, feat_local, adj_local, b1, b2, mask, neg_ids,
    generator=None) -> (loss, mrr, dropped) of one validation batch,
    split over the graph group (each data slice evaluates it whole; its
    length must split evenly). Graph rank g scores against its own
    negatives ``neg_ids[g]`` ([graph_size, n_neg]); the loss carries
    the single-device eval's decay term and the MRR is the exact
    masked mean over the group."""
    D, g, group = grid.graph_size, grid.graph_rank, grid.graph_group

    @torch.inference_mode()
    def eval_fn(params, feat_local, adj_local, b1, b2, mask, neg_ids,
                generator=None):
        lb = b1.shape[0] // D
        sl = slice(g * lb, (g + 1) * lb)
        part, dropped = _unsup_batch_sums(
            unsup_config, params, feat_local, adj_local, b1[sl], b2[sl],
            mask[sl], neg_ids[g], group, capacity_factor, generator)
        loss, mrr = _unsup_eval_values(unsup_config, params,
                                       _all_reduce(part, group))
        return loss, mrr, _all_reduce(dropped, group)

    return eval_fn


def make_sharded_unsup_eval_sweep(unsup_config, grid, batch_size: int,
                                  capacity_factor: float = 4.0):
    """sweep(params, feat_local, adj_local, pairs_all, neg_ids,
    generator=None) -> (loss, mrr, dropped): the means over every real
    pair of a dummy-padded pair stream (the same on every rank), each
    batch weighted by its real pairs, as the single-device sweep
    (``train/unsupervised.py::make_unsup_eval_sweep``) weighs them.

    Each batch splits over the whole grid graph-major
    (``_graph_major_me``), and graph rank g scores against ``neg_ids[g]``:
    every pair keeps the graph rank and the negatives it has on a
    1 x D grid, so with a position-independent sampler (first_k,
    shared_perm; ``generator`` the same on every rank) the loss and
    MRR do not move when only ``--data_shards`` changes (to the
    rounding of the reduction's order). One all-reduce a batch, one a
    sweep for the dropped count."""
    config = unsup_config.sage
    num_nodes = config.num_nodes
    _require_num_nodes(num_nodes, "pair stream")
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total
    me = _graph_major_me(grid)

    @torch.inference_mode()
    def sweep(params, feat_local, adj_local, pairs_all, neg_ids,
              generator=None):
        device = pairs_all.device
        neg = neg_ids[grid.graph_rank]
        loss_sum = mrr_sum = count = torch.zeros((), device=device)
        dropped_tot = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(pairs_all.shape[0] // batch_size):
            lo = i * batch_size + me * local_b
            pair = pairs_all[lo:lo + local_b]
            mask = (pair[:, 0] != num_nodes).float()
            part, dropped = _unsup_batch_sums(
                unsup_config, params, feat_local, adj_local, pair[:, 0],
                pair[:, 1], mask, neg, grid.graph_group, capacity_factor,
                generator)
            total = _all_reduce(part)
            loss, mrr = _unsup_eval_values(unsup_config, params, total)
            k = total[2]
            loss_sum, mrr_sum = loss_sum + loss * k, mrr_sum + mrr * k
            count = count + k
            dropped_tot += dropped
        count = torch.clamp(count, min=1.0)
        return loss_sum / count, mrr_sum / count, _all_reduce(dropped_tot)

    return sweep


def make_sharded_unsup_embed(unsup_config, grid,
                             capacity_factor: float = 4.0):
    """embed_fn(params, feat_local, adj_local, ids, generator=None) ->
    (l2-normalised embeddings of this rank's ``ids``, this rank's
    dropped count): the sharded export's forward, no dropout."""
    config = unsup_config.sage

    @torch.inference_mode()
    def embed_fn(params, feat_local, adj_local, ids, generator=None):
        out, dropped = sharded_sage_embed(
            params, feat_local, adj_local, ids, config, grid.graph_group,
            capacity_factor, generator=generator, deterministic=True,
            return_stats=True)
        return l2_normalize(out, 1), dropped

    return embed_fn


def make_sharded_embed_sweep(unsup_config, grid, batch_size: int,
                             capacity_factor: float = 4.0):
    """sweep(params, feat_local, adj_local, ids_all, generator=None) ->
    (this rank's rows [n_b * B/total, dim], dropped): every id of a
    dummy-padded stream (the same on every rank) through
    ``make_sharded_unsup_embed``, each batch split over the whole grid
    data-major. ``reassemble_sharded_rows`` over the total shard count
    puts the ranks' stacked rows (``distributed.host_array``) in the
    stream's order. One all-reduce a sweep, for the dropped count."""
    _check_batch_divisible(grid, batch_size)
    local_b = batch_size // grid.total
    embed_fn = make_sharded_unsup_embed(unsup_config, grid, capacity_factor)

    @torch.inference_mode()
    def sweep(params, feat_local, adj_local, ids_all, generator=None):
        n_b = ids_all.shape[0] // batch_size
        out = torch.empty(n_b * local_b, unsup_config.sage.output_dim,
                          device=ids_all.device)
        dropped_tot = torch.zeros((), dtype=torch.int32,
                                  device=ids_all.device)
        for i in range(n_b):
            lo = i * batch_size + grid.me * local_b
            out[i * local_b:(i + 1) * local_b], dropped = embed_fn(
                params, feat_local, adj_local, ids_all[lo:lo + local_b],
                generator)
            dropped_tot += dropped
        return out, _all_reduce(dropped_tot)

    return sweep


def reassemble_sharded_rows(arr: np.ndarray, n_shards: int,
                            n_batches: int) -> np.ndarray:
    """Rank-major sweep rows ([D * n_b * local, ...], the ranks' outputs
    stacked) -> the id stream's step-major order ([n_b * D * local])."""
    local = arr.shape[0] // (n_shards * n_batches)
    shaped = arr.reshape((n_shards, n_batches, local) + arr.shape[1:])
    return np.ascontiguousarray(shaped.swapaxes(0, 1)).reshape(
        (n_batches * n_shards * local,) + arr.shape[1:])
