"""Supervised GraphSAGE: embed -> l2-normalize -> dense head -> loss.

Sigmoid (multilabel) or softmax loss over a mask-weighted batch mean,
plus weight decay over the aggregator projections and the head. The
optimizer comes with the training slice.
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
from graphsage_tpu_torch.nn.dense import apply_dense, init_dense


@dataclasses.dataclass(frozen=True)
class SupervisedConfig:
    sage: SAGEConfig
    num_classes: int
    sigmoid_loss: bool = False
    weight_decay: float = 0.0


def head_params(params: dict) -> dict:
    return {"w": params["head.w"], "b": params["head.b"]}


def init_supervised_params(generator: torch.Generator,
                           config: SupervisedConfig, device="cpu") -> dict:
    params = init_sage_params(generator, config.sage, device)
    head = init_dense(generator, config.sage.output_dim, config.num_classes,
                      bias=True, device=device)
    params.update({f"head.{k}": v for k, v in head.items()})
    return params


def supervised_logits(params, features, adj, ids, config: SupervisedConfig,
                      generator=None, deterministic: bool = True):
    emb = sage_embed(params, features, adj, ids, config.sage,
                     generator=generator, deterministic=deterministic)
    return apply_dense(
        head_params(params), l2_normalize(emb, dim=1), act=None,
        dropout_rate=config.sage.dropout, generator=generator,
        deterministic=deterministic,
    )


def _softmax_xent(logits, labels):
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def _sigmoid_xent(logits, labels):
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).sum(dim=-1)


def supervised_loss(params, features, adj, ids, labels, mask,
                    config: SupervisedConfig, generator=None,
                    deterministic: bool = False):
    """(masked mean loss + weight decay, logits). The sigmoid loss sums
    over classes per node and divides by C; softmax reduces per node."""
    logits = supervised_logits(params, features, adj, ids, config,
                               generator=generator,
                               deterministic=deterministic)
    if config.sigmoid_loss:
        per_node = _sigmoid_xent(logits, labels) / config.num_classes
    else:
        per_node = _softmax_xent(logits, labels)
    loss = (per_node * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if config.weight_decay > 0.0:
        decayed = sage_decay_weights(params, config.sage)
        decayed += [params["head.w"], params["head.b"]]
        loss = loss + config.weight_decay * sum(
            0.5 * (w * w).sum() for w in decayed
        )
    return loss, logits


def supervised_predict(logits, config: SupervisedConfig):
    """Class probabilities: sigmoid per class, or a softmax."""
    if config.sigmoid_loss:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)
