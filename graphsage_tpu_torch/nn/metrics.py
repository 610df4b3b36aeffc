"""Masked losses and accuracy, and the reference's MLP baseline.

The reference's metrics module (the tkipf/gcn helpers) and its MLP
model, their only user. The reference's ``masked_l2`` calls a function
TF does not have; here it has the intended semantics, half the squared
error per element (``tf.nn.l2_loss``'s convention).
"""

from __future__ import annotations

import torch

from graphsage_tpu_torch.nn.dense import apply_dense, init_dense


def _norm_mask(mask):
    mask = mask.float()
    return mask / torch.clamp(mask.sum(), min=1.0)


def masked_logit_cross_entropy(preds, labels, mask):
    """Sigmoid xent summed over classes, mask-normalized."""
    loss = (torch.clamp(preds, min=0) - preds * labels
            + torch.log1p(torch.exp(-preds.abs()))).sum(dim=1)
    return (loss * _norm_mask(mask)).mean()


def masked_softmax_cross_entropy(preds, labels, mask):
    """Softmax xent, mask-normalized."""
    loss = -(labels * torch.log_softmax(preds, dim=-1)).sum(dim=-1)
    return (loss * _norm_mask(mask)).mean()


def masked_l2(preds, actuals, mask):
    """0.5 ||preds - actuals||^2 per row, weighted by the mask over its
    mean."""
    loss = 0.5 * ((preds - actuals) ** 2).sum(dim=1)
    m = mask.float()
    return (loss * (m / torch.clamp(m.mean(), min=1e-12))).mean()


def masked_accuracy(preds, labels, mask):
    """Argmax accuracy, weighted by the mask over its mean."""
    correct = (preds.argmax(dim=1) == labels.argmax(dim=1)).float()
    m = mask.float()
    return (correct * (m / torch.clamp(m.mean(), min=1e-12))).mean()


def init_mlp_params(generator: torch.Generator, dims, device="cpu") -> dict:
    """Two dense layers with biases: dims = (input, hidden, output)."""
    return {"l1": init_dense(generator, dims[0], dims[1], True, device),
            "l2": init_dense(generator, dims[1], dims[2], True, device)}


def mlp_forward(params, x, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None,
                deterministic: bool = True):
    h = apply_dense(params["l1"], x, act=torch.relu,
                    dropout_rate=dropout_rate, generator=generator,
                    deterministic=deterministic)
    return apply_dense(params["l2"], h, dropout_rate=dropout_rate,
                       generator=generator, deterministic=deterministic)


def mlp_loss(params, x, labels, mask, weight_decay: float = 0.0,
             categorical: bool = True, dropout_rate: float = 0.0,
             generator: torch.Generator | None = None,
             deterministic: bool = True):
    """(loss, out): weight decay over the first layer's variables, plus
    the masked softmax xent (``categorical``) or the sum of the rows'
    L2 distances (regression)."""
    out = mlp_forward(params, x, dropout_rate, generator, deterministic)
    loss = weight_decay * sum(0.5 * (w * w).sum()
                              for w in params["l1"].values())
    if categorical:
        loss = loss + masked_softmax_cross_entropy(out, labels, mask)
    else:
        diff = labels - out
        loss = loss + torch.sqrt((diff * diff).sum(dim=1)).sum()
    return loss, out
