"""Supervised GraphSAGE: embed -> l2-normalize -> dense head -> loss.

Sigmoid (multilabel) or softmax loss over a mask-weighted batch mean,
plus weight decay over the aggregator projections and the head (in the
loss, never in the optimizer), and the optimizer: each gradient element
clipped to +-5, then Adam.
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
from graphsage_tpu_torch.nn.prediction import sigmoid_xent


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
                      generator=None, deterministic: bool = True,
                      drop_key=None):
    emb = sage_embed(params, features, adj, ids, config.sage,
                     generator=generator, deterministic=deterministic,
                     drop_key=drop_key)
    return apply_dense(
        head_params(params), l2_normalize(emb, dim=1), act=None,
        dropout_rate=config.sage.dropout, generator=generator,
        deterministic=deterministic,
    )


def _softmax_xent(logits, labels):
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def per_node_loss(logits, labels, config: SupervisedConfig):
    """[B] loss of each node: the sigmoid loss sums over classes and
    divides by C; softmax reduces per node."""
    if config.sigmoid_loss:
        return sigmoid_xent(labels, logits).sum(dim=-1) / config.num_classes
    return _softmax_xent(logits, labels)


def supervised_loss(params, features, adj, ids, labels, mask,
                    config: SupervisedConfig, generator=None,
                    deterministic: bool = False, drop_key=None):
    """(masked mean of ``per_node_loss`` + weight decay, logits).
    ``drop_key`` = (seed, step) keys the fused hop's dropout masks."""
    logits = supervised_logits(params, features, adj, ids, config,
                               generator=generator,
                               deterministic=deterministic,
                               drop_key=drop_key)
    per_node = per_node_loss(logits, labels, config)
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


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """``optax.chain(optax.clip(clip), optax.adam(lr, b1, b2, eps))`` over
    the flat parameter dict: every gradient element clipped to
    +-``clip``, then ``torch.optim.Adam``, whose step is optax's formula
    (eps added outside the square root of the bias-corrected second
    moment). ``init`` gives the optimizer state, the ``torch.optim.Adam``
    that holds the moments; ``update`` applies one step in place."""

    learning_rate: float
    clip: float = 5.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> torch.optim.Adam:
        for p in params.values():
            p.requires_grad_(True)
        return torch.optim.Adam(list(params.values()), lr=self.learning_rate,
                                betas=(self.b1, self.b2), eps=self.eps)

    def update(self, opt_state: torch.optim.Adam, params: dict) -> None:
        with torch.no_grad():
            for p in params.values():
                if p.grad is None:   # optax steps every leaf
                    p.grad = torch.zeros_like(p)
                p.grad.clamp_(-self.clip, self.clip)
        opt_state.step()

    @staticmethod
    def state_dict(opt_state: torch.optim.Adam, params: dict) -> dict:
        """The moments as optax keeps them: {"count": int, "mu": {key:
        tensor}, "nu": {key: tensor}}, keyed by the parameter paths."""
        count, mu, nu = 0, {}, {}
        for k, p in params.items():
            st = opt_state.state.get(p)
            if st:
                count = int(st["step"])
                mu[k], nu[k] = st["exp_avg"].detach(), st["exp_avg_sq"].detach()
            else:
                mu[k], nu[k] = torch.zeros_like(p), torch.zeros_like(p)
        return {"count": count, "mu": mu, "nu": nu}

    @staticmethod
    def load_state_dict(opt_state: torch.optim.Adam, params: dict,
                        state: dict) -> None:
        """Inverse of ``state_dict``: set every parameter's moments and
        the step count."""
        for k, p in params.items():
            opt_state.state[p] = {
                "step": torch.tensor(float(state["count"]),
                                     dtype=torch.float32),
                "exp_avg": state["mu"][k].to(p).clone(),
                "exp_avg_sq": state["nu"][k].to(p).clone(),
            }


def make_optimizer(learning_rate: float, clip: float = 5.0) -> ClippedAdam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) after clipping each gradient
    element to +-``clip``, as the JAX package's ``make_optimizer``."""
    return ClippedAdam(learning_rate, clip)
