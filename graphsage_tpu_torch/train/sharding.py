"""What the supervised and the unsupervised trainers share on several
devices: a rank's shard of the feature table, its params with the
identity table row-sharded, the checkpoint's whole, canonical state and
back, the restore of ``--resume``, and the dropped-request warnings.

A checkpoint keeps the identity table (``embeds``) and its Adam moments
whole, in canonical id order, so a run resumes under any shard count or
``--shard_layout``, or on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from graphsage_tpu_torch.data.io import feature_stats, load_feature_rows
from graphsage_tpu_torch.parallel.graph_sharded import (
    device_rows_to_node_ids,
    gather_canonical,
    local_shard,
)
from graphsage_tpu_torch.train import checkpoint as ckpt
from graphsage_tpu_torch.train.config import FEATURE_DTYPES


def quiet(*args, **kwargs) -> None:
    """``print`` of a rank that is not rank 0."""


def place_sharded_features(graph, n_shards: int, index: int,
                           feature_dtype: str, layout: str, device):
    """Shard ``index`` of the dummy-padded feature table on ``device``, in
    ``feature_dtype`` (None in featureless mode). An in-memory table is
    sliced on the host; a deferred one (``--defer_features``) reads only
    this shard's rows off the disk (``load_feature_rows``, standardised
    with the train rows' ``feature_stats``), so no rank holds the whole
    table."""
    if feature_dtype not in FEATURE_DTYPES:
        raise ValueError(
            f"feature_dtype must be one of {tuple(FEATURE_DTYPES)}")
    dtype = FEATURE_DTYPES[feature_dtype]
    feats_np = graph.padded_features()
    if feats_np is not None:
        rows = local_shard(feats_np, n_shards, index, layout)
    elif graph.feature_meta is not None:
        shard_size = -(-(graph.num_nodes + 1) // n_shards)
        node_ids = device_rows_to_node_ids(
            np.arange(index * shard_size, (index + 1) * shard_size),
            n_shards, shard_size, layout)
        rows = load_feature_rows(graph, node_ids, stats=feature_stats(graph))
    else:
        return None
    return torch.from_numpy(rows).to(device=device, dtype=dtype)


def canonical_state(params: dict, opt_state: dict, grid, layout: str,
                    n_rows: int):
    """A checkpoint's (params, Adam state) with the row-sharded identity
    table and its moments whole, in canonical id order (collective over
    the graph group)."""
    if "embeds" not in params:
        return params, opt_state
    params = dict(params)
    params["embeds"] = gather_canonical(params["embeds"].detach(), grid,
                                        n_rows, layout)
    opt_state = dict(opt_state)
    for m in ("mu", "nu"):
        opt_state[m] = dict(opt_state[m])
        opt_state[m]["embeds"] = gather_canonical(
            opt_state[m]["embeds"], grid, n_rows, layout)
    return params, opt_state


def local_state(tree: dict, grid, layout: str) -> dict:
    """This rank's shard of a canonical ``embeds`` leaf, the rest kept."""
    if "embeds" not in tree:
        return tree
    tree = dict(tree)
    e = tree["embeds"]
    tree["embeds"] = torch.from_numpy(local_shard(
        e.cpu().numpy(), grid.graph_size, grid.graph_rank, layout)).to(
            e.device)
    return tree


def sharded_params(whole: dict, grid, layout: str):
    """(this rank's params, the checkpoint's shapes) from the whole
    initial params: the identity table cut to the rank's shard, its
    whole shape kept for ``ckpt.check_matches``."""
    params = local_state(whole, grid, layout)
    saved_like = dict(params)
    if "embeds" in whole:
        saved_like["embeds"] = torch.empty(whole["embeds"].shape,
                                           device="meta")
    return params, saved_like


def restore(flags, params: dict, optimizer, opt_state, saved_like: dict,
            to_local, device, say) -> int:
    """``--resume``: the newest checkpoint under ``flags.checkpoint_dir``
    copied into ``params`` and ``opt_state`` (``to_local`` of its
    canonical state); returns its step, 0 without one."""
    restored = ckpt.restore_train_state(flags.checkpoint_dir, device)
    if restored is None:
        return 0
    saved, saved_opt, step = restored
    ckpt.check_matches(saved, saved_like)
    with torch.no_grad():
        for k, v in to_local(saved).items():
            params[k].copy_(v)
    if saved_opt is not None:
        saved_opt = dict(saved_opt, mu=to_local(saved_opt["mu"]),
                         nu=to_local(saved_opt["nu"]))
        optimizer.load_state_dict(opt_state, params, saved_opt)
    else:
        say("The checkpoint holds no optimizer state: Adam "
            "starts from zero moments")
    say(f"Resumed from checkpoint at step {step}")
    return step


class DroppedRequests:
    """The exchange's overflowed requests, warned where the host reads
    them (the JAX package's warning) and totalled."""

    def __init__(self, capacity_factor: float, say):
        self.capacity_factor, self.say, self.total = capacity_factor, say, 0

    def note(self, dropped, where: str) -> None:
        d = int(dropped)
        if d > 0:
            self.total += d
            self.say(f"WARNING: {where}: {d} gather requests overflowed the "
                     f"all-to-all capacity and returned ZERO rows "
                     f"(capacity_factor={self.capacity_factor:.2f}; total "
                     f"dropped {self.total}). Raise --capacity_factor.")
