"""Unsupervised GraphSAGE: three towers and a skip-gram negative-sampling
loss.

The reference's SampleAndAggregate: the batch1 and batch2 towers share
the aggregators' parameters, a tower of unigram^0.75 negatives feeds a
dense [B, n_neg] affinity matrix, every output is l2-normalised, and
the loss is divided by the batch size (the count of real rows here).
The caller draws the negatives (``nn/negative.py``) and passes their
ids, whose count is n_neg, so that two runs, or two packages, can share
them.
"""

from __future__ import annotations

import dataclasses

import torch

from graphsage_tpu_torch.models.graphsage import (
    SAGEConfig,
    init_sage_params,
    l2_normalize,
    sage_decay_weights,
    sage_embed,
)
from graphsage_tpu_torch.nn import prediction


@dataclasses.dataclass(frozen=True)
class UnsupervisedConfig:
    sage: SAGEConfig
    neg_sample_weights: float = 1.0
    loss_fn: str = "xent"
    weight_decay: float = 0.0


def init_unsupervised_params(generator: torch.Generator,
                             config: UnsupervisedConfig,
                             device="cpu") -> dict:
    """The aggregators (and identity table): no head."""
    return init_sage_params(generator, config.sage, device)


def unsupervised_outputs(params, features, adj, batch1, batch2, neg_ids,
                         config: UnsupervisedConfig, generator=None,
                         deterministic: bool = True, drop_key=None):
    """(out1, out2, neg_out), each l2-normalised.

    The three towers run as one ``sage_embed`` over ``cat([batch1,
    batch2, neg_ids])``: one frontier expansion and one innermost-hop
    kernel launch instead of three, and under ``shared_perm`` one
    column permutation per hop for all three, as the JAX package draws
    them. Every node's sample-and-aggregate is independent, so the
    math is the reference's."""
    B = batch1.shape[0]
    all_ids = torch.cat([batch1, batch2, neg_ids])
    out = sage_embed(params, features, adj, all_ids, config.sage,
                     generator=generator, deterministic=deterministic,
                     drop_key=drop_key)
    return (l2_normalize(out[:B], 1), l2_normalize(out[B:2 * B], 1),
            l2_normalize(out[2 * B:], 1))


def unsupervised_loss(params, features, adj, batch1, batch2, mask, neg_ids,
                      config: UnsupervisedConfig, generator=None,
                      deterministic: bool = False, drop_key=None):
    """(loss, aux): the edge-prediction loss over the real rows' count,
    plus weight decay over the aggregators' projections; ``aux`` holds
    ``mrr``, ``ranks`` and ``outputs1``, detached. The affinities are
    ``prediction.edge_pred_scores``', the scoring of
    ``prediction.edge_pred_loss``."""
    out1, out2, neg = unsupervised_outputs(
        params, features, adj, batch1, batch2, neg_ids, config,
        generator=generator, deterministic=deterministic, drop_key=drop_key)
    aff, neg_aff = prediction.edge_pred_scores(out1, out2, neg)
    raw = prediction.pair_loss(aff, neg_aff, config.loss_fn, mask,
                               config.neg_sample_weights)
    loss = raw / torch.clamp(mask.sum(), min=1.0)
    if config.weight_decay > 0.0:
        loss = loss + config.weight_decay * sum(
            0.5 * (w * w).sum()
            for w in sage_decay_weights(params, config.sage))
    ranks, mrr = prediction.mrr_and_ranks(aff.detach(), neg_aff.detach(),
                                          mask)
    return loss, {"mrr": mrr, "ranks": ranks, "outputs1": out1.detach()}
