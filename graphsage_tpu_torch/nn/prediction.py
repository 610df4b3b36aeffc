"""Edge-prediction (skip-gram style) scoring and losses.

The reference's BipartiteEdgePredLayer as functions: dot-product or
bilinear affinity, the dense [B, num_neg] affinity to a shared negative
set, and the xent / skipgram / hinge losses. Every reduction is
mask-weighted, so dummy-padded batch rows contribute nothing.
"""

from __future__ import annotations

import torch

from graphsage_tpu_torch.nn.init import glorot

MARGIN = 0.1  # hinge margin


def init_bilinear(generator: torch.Generator, input_dim1: int,
                  input_dim2: int, device="cpu") -> dict:
    """Optional bilinear affinity weights, u^T A v."""
    return {"w": glorot(generator, (input_dim1, input_dim2), device)}


def _project(x1, params=None):
    """x1 A, the bilinear affinity's left factor (x1 itself without
    ``params``): every score below is x1 A x2^T."""
    return x1 if params is None else x1 @ params["w"]


def affinity(x1, x2, params=None):
    """[B] dot-product (or bilinear) affinity."""
    return (_project(x1, params) * x2).sum(dim=1)


def neg_cost(x1, neg, params=None):
    """[B, num_neg] affinities to the shared negative set."""
    return _project(x1, params) @ neg.T


def edge_pred_scores(x1, x2, neg, params=None):
    """(aff [B], neg_aff [B, num_neg]): ``affinity`` and ``neg_cost``
    from one product x1 A [neg; x2]^T, the positives on the diagonal of
    its x2 block. One product rounds every score alike, so a positive
    whose embedding equals a negative's ties it exactly on every device
    and ranks below it (``mrr_and_ranks``)."""
    n_neg = neg.shape[0]
    scores = _project(x1, params) @ torch.cat([neg, x2]).T
    return scores[:, n_neg:].diagonal(), scores[:, :n_neg]


def sigmoid_xent(labels, logits):
    """tf.nn.sigmoid_cross_entropy_with_logits, with the JAX package's
    subgradients at a logit of exactly 0 (the affinity of the dummy
    node's zero embedding): ``maximum`` splits the tie, |x| has slope 1
    there."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-abs_logits)))


def xent_loss(aff, neg_aff, mask=None, neg_sample_weights: float = 1.0):
    """sum(xent(aff, 1)) + w * sum(xent(neg_aff, 0))."""
    true_xent = sigmoid_xent(torch.ones_like(aff), aff)
    neg_xent = sigmoid_xent(torch.zeros_like(neg_aff), neg_aff)
    if mask is not None:
        true_xent = true_xent * mask
        neg_xent = neg_xent * mask[:, None]
    return true_xent.sum() + neg_sample_weights * neg_xent.sum()


def skipgram_loss(aff, neg_aff, mask=None):
    """sum(aff - logsumexp(neg_aff))."""
    per = aff - torch.logsumexp(neg_aff, dim=1)
    if mask is not None:
        per = per * mask
    return per.sum()


def hinge_loss(aff, neg_aff, mask=None, margin: float = MARGIN):
    """sum(relu(neg_aff - aff + margin))."""
    diff = torch.relu(neg_aff - (aff[:, None] - margin))
    if mask is not None:
        diff = diff * mask[:, None]
    return diff.sum()


LOSS_FNS = {
    "xent": xent_loss,
    "skipgram": skipgram_loss,
    "hinge": hinge_loss,
}


def pair_loss(aff, neg_aff, loss_fn: str = "xent", mask=None,
              neg_sample_weights: float = 1.0):
    """The named loss of given affinities (only xent weighs negatives)."""
    if loss_fn == "xent":
        return xent_loss(aff, neg_aff, mask, neg_sample_weights)
    return LOSS_FNS[loss_fn](aff, neg_aff, mask)


def edge_pred_loss(x1, x2, neg, *, loss_fn: str = "xent", params=None,
                   mask=None, neg_sample_weights: float = 1.0):
    """The named loss of ``edge_pred_scores``."""
    aff, neg_aff = edge_pred_scores(x1, x2, neg, params)
    return pair_loss(aff, neg_aff, loss_fn, mask, neg_sample_weights)


def mrr_and_ranks(aff, neg_aff, mask=None):
    """(ranks [B] int32, batch MRR). The reference appends the positive
    after the negatives and breaks top_k ties toward lower indices, so
    a tie ranks the positive below the negative:
    rank = 1 + #{neg_aff >= aff}."""
    ranks = 1 + (neg_aff >= aff[:, None]).sum(dim=1, dtype=torch.int32)
    rr = 1.0 / ranks.float()
    if mask is None:
        return ranks, rr.mean()
    return ranks, (rr * mask).sum() / torch.clamp(mask.sum(), min=1.0)
