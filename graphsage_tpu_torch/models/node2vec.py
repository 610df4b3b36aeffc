"""node2vec/DeepWalk: embedding tables and the skip-gram loss.

The reference's Node2VecModel: a target and a context table (and a
context bias) of ``num_nodes`` rows, unique unigram^0.75 negatives,
sigmoid cross-entropy summed and divided by the count of real rows,
plain SGD, and the MRR of the GraphSAGE models. The caller draws the
negatives (``nn/negative.py``) and passes their ids, so that two runs,
or two packages, can share them.

The post-hoc inductive retrain freezes the context rows of the train
nodes: ``mask_context_gradients`` multiplies a [num_nodes] mask into
the context table's gradient.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from graphsage_tpu_torch.nn import prediction


@dataclasses.dataclass(frozen=True)
class Node2VecConfig:
    num_nodes: int          # N+1: the dummy-padded table size
    dim: int = 256          # the reference uses 2 * dim_1
    neg_sample_size: int = 20
    learning_rate: float = 0.001


def init_node2vec_params(generator: torch.Generator, config: Node2VecConfig,
                         device="cpu") -> dict:
    """target uniform(-1, 1), context truncated normal (std 1/sqrt(dim),
    cut at 2 std), bias zeros: drawn from the CPU ``generator``, then
    moved, so the same seed gives the same tables on every device."""
    n, d = config.num_nodes, config.dim
    std = 1.0 / math.sqrt(d)
    target = torch.empty(n, d).uniform_(-1.0, 1.0, generator=generator)
    context = torch.nn.init.trunc_normal_(
        torch.empty(n, d), std=std, a=-2 * std, b=2 * std,
        generator=generator)
    return {"target": target.to(device), "context": context.to(device),
            "bias": torch.zeros(n, device=device)}


def node2vec_outputs(params, batch1, batch2, neg_ids):
    """(out1, out2, out2_bias, neg, neg_bias): the rows of the tables."""
    return (params["target"].index_select(0, batch1),
            params["context"].index_select(0, batch2),
            params["bias"].index_select(0, batch2),
            params["context"].index_select(0, neg_ids),
            params["bias"].index_select(0, neg_ids))


def node2vec_loss(params, batch1, batch2, mask, neg_ids,
                  config: Node2VecConfig):
    """(loss, aux): the xent of the affinities with the context bias,
    summed over real rows and divided by their count; aux holds the
    bias-free MRR and ranks and the target rows. Positive and negative
    scores come from one product (``edge_pred_scores``), so a positive
    that equals a negative ties it on every device."""
    out1, out2, out2_bias, neg, neg_bias = node2vec_outputs(
        params, batch1, batch2, neg_ids)
    plain_aff, plain_neg = prediction.edge_pred_scores(out1, out2, neg)
    aff = plain_aff + out2_bias
    neg_aff = plain_neg + neg_bias
    true_xent = prediction.sigmoid_xent(torch.ones_like(aff), aff)
    neg_xent = prediction.sigmoid_xent(torch.zeros_like(neg_aff), neg_aff)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ((true_xent * mask).sum()
            + (neg_xent * mask[:, None]).sum()) / denom
    ranks, mrr = prediction.mrr_and_ranks(plain_aff.detach(),
                                          plain_neg.detach(), mask)
    return loss, {"mrr": mrr, "ranks": ranks, "outputs1": out1.detach()}


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(learning_rate)`` over the flat parameter dict: ``init``
    gives the optimizer state, a ``torch.optim.SGD`` without momentum,
    whose step is ``p - learning_rate * grad`` over the whole (dense)
    gradient; ``update`` applies one step in place."""

    learning_rate: float

    def init(self, params: dict) -> torch.optim.SGD:
        for p in params.values():
            p.requires_grad_(True)
        return torch.optim.SGD(list(params.values()), lr=self.learning_rate)

    def update(self, opt_state: torch.optim.SGD, params: dict) -> None:
        opt_state.step()


def make_optimizer(learning_rate: float) -> SGD:
    """Plain SGD (the reference's GradientDescentOptimizer)."""
    return SGD(learning_rate)


def mask_context_gradients(params: dict, context_update_mask) -> None:
    """Zero the context table's gradient rows where the mask is 0, in
    place: the retrain's freeze of already-trained rows."""
    grad = params["context"].grad
    if grad is not None:
        grad.mul_(context_update_mask[:, None])
