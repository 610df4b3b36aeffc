"""Faults planted in the port underneath the harness, each of which the
output check has to refuse: the tests drive them at a toy size on the
CPU, ``calibrate.py`` reads them at a cell's own size on the card.

- ``unchanged_state``: the optimizer's update does nothing, so a step
  returns its state unchanged.
- ``half_batch``: the loss is the mean over the first half of the
  batch, the rest left out.
- ``half_neighbours``: the innermost hop's kernels reduce over the first
  half of each row's samples.
- ``altered_answer``: where the predictions are made, one node's are
  rolled by one class; in training the loss is scaled by 1.001 where it
  is made.
- ``half_lr``: the optimizer steps at half the learning rate.
- ``pool_grad_halved``: the fused gather-MLP-pool's backward returns
  half the gradient of its MLP's weight and bias.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged_state", "half_batch", "half_neighbours",
          "altered_answer", "half_lr", "pool_grad_halved")
# the faults a mode's cell can have
FOR_MODE = {"train": FAULTS,
            "sweep": ("half_neighbours", "altered_answer"),
            "requests": ("half_neighbours", "altered_answer")}


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


class _HalfGrad(torch.autograd.Function):
    """The identity, with half the gradient on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * 0.5


@contextlib.contextmanager
def planted(fault: str):
    from graphsage_tpu_torch.models import graphsage, supervised
    from graphsage_tpu_torch.parallel import dp
    from graphsage_tpu_torch.train import supervised as train_sup

    if fault == "unchanged_state":
        with _patched(supervised.ClippedAdam, "update",
                      lambda self, opt_state, params: None):
            yield
    elif fault == "half_batch":
        loss_fn = dp.supervised_loss

        def half(params, features, adj, ids, labels, mask, config, **kw):
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
            return loss_fn(params, features, adj, ids, labels, mask, config,
                           **kw)
        with _patched(dp, "supervised_loss", half):
            yield
    elif fault == "half_neighbours":
        mean_fn, pool_fn = (graphsage.fused_gather_mean,
                            graphsage.gather_mlp_pool_train)

        def halve(idx):
            return idx[:, :max(1, idx.shape[1] // 2)].contiguous()
        with _patched(graphsage, "fused_gather_mean",
                      lambda f, idx, **kw: mean_fn(f, halve(idx), **kw)), \
                _patched(graphsage, "gather_mlp_pool_train",
                         lambda f, idx, *a, **kw: pool_fn(f, halve(idx), *a,
                                                          **kw)):
            yield
    elif fault == "altered_answer":
        predict, loss_fn = train_sup.supervised_predict, dp.supervised_loss

        def rolled(logits, config):
            p = predict(logits, config).clone()
            p[0] = p[0].roll(1)
            return p

        def scaled(*a, **kw):
            value, logits = loss_fn(*a, **kw)
            return value * 1.001, logits
        with _patched(train_sup, "supervised_predict", rolled), \
                _patched(dp, "supervised_loss", scaled):
            yield
    elif fault == "half_lr":
        update = supervised.ClippedAdam.update

        def halved(self, opt_state, params):
            for group in opt_state.param_groups:
                group["lr"] = self.learning_rate / 2
            update(self, opt_state, params)
        with _patched(supervised.ClippedAdam, "update", halved):
            yield
    elif fault == "pool_grad_halved":
        pool_fn = graphsage.gather_mlp_pool_train

        def half_grad(f, idx, w, b, *a, **kw):
            return pool_fn(f, idx, _HalfGrad.apply(w), _HalfGrad.apply(b),
                           *a, **kw)
        with _patched(graphsage, "gather_mlp_pool_train", half_grad):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
