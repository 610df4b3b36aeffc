"""The aggregators, as init/apply function pairs.

  mean       — neighbor mean -> two matmuls (self/neigh), add or concat
  gcn        — mean over {neighbors + self} -> one shared matmul
  maxpool    — per-neighbor MLP -> elementwise max -> two matmuls
  meanpool   — the same with a mean reduction
  twomaxpool — a 2-layer MLP, then the max
  seq        — an LSTM over the neighbor sequence (``nn/lstm.py``), its
               last output -> two matmuls

mean and gcn drop out both inputs. Each takes the neighbor input either
as [n, S, d] rows or as the pre-reduced [n, d] mean that the fused
gather-mean kernel produces; the pre-reduced form skips the neighbor
dropout (the kernel's caller owns it). The pooling aggregators drop out
only the MLP's input (each Dense drops its input), never the self
input; maxpool and meanpool also take ``pre_pooled`` [n, H] input, the
fused gather -> MLP -> pool kernel's result, and then skip the MLP and
the reduce. The max is ``torch.amax``, whose gradient splits evenly
among ties as ``jnp.max``'s does. seq takes no dropout, as in the
reference.

Rows of a bf16 feature table stay bf16 through dropout and the
neighbor mean, which is rounded to bf16 as ``jnp.mean`` rounds it (an
f32 sum and division, then the cast); only the matrix product promotes
them to f32, as ``jnp.dot(bf16, f32, preferred_element_type=f32)``
does in the JAX package.

Layer 0 under tensor parallelism takes ``shard`` (a
``parallel/tensor.py::ModelShard``): its inputs are a rank's block of
the raw input's columns and each weight that contracts them is the
matching block of rows, so every such product is a partial sum, added
over the model group before bias and activation (``shard.reduce``):
mean's two projections (one reduce of the two, joined), gcn's one, the
pooling MLP's first layer and the self projection, the LSTM's input
projection and the self projection. The plain dropout of the block
draws the whole row's mask (``shard.dropout``).
"""

from __future__ import annotations

import torch

from graphsage_tpu_torch.nn.dense import apply_dense, init_dense
from graphsage_tpu_torch.nn.init import dropout, glorot, zeros
from graphsage_tpu_torch.nn.lstm import (
    init_lstm,
    lstm_last_output,
    neighbor_lengths,
)

POOL_HIDDEN = {"small": 512, "big": 1024}
TWOPOOL_HIDDEN = {"small": (512, 256), "big": (1024, 512)}
LSTM_HIDDEN = {"small": 128, "big": 256}


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean in f32, returned in ``x``'s dtype."""
    return x.float().mean(dim=dim).to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.to(w.dtype) @ w


def _combine(from_self, from_neighs, params, act, concat, reduce=None):
    if concat:
        out = torch.cat([from_self, from_neighs], dim=1)
    else:
        out = from_self + from_neighs
    if reduce is not None:
        out = reduce(out)
    if "b" in params:
        out = out + params["b"]
    return act(out)


# ---------------------------------------------------------------- mean

def init_mean(generator, input_dim, output_dim, model_size="small",
              bias=False, device="cpu") -> dict:
    p = {
        "neigh_w": glorot(generator, (input_dim, output_dim), device),
        "self_w": glorot(generator, (input_dim, output_dim), device),
    }
    if bias:
        p["b"] = zeros((output_dim,), device)
    return p


def _drop_and_reduce(shard):
    """(dropout, reduce) of layer 0's block under ``shard``, else the
    plain dropout and no reduce."""
    if shard is None:
        return dropout, None
    return shard.dropout, shard.reduce


def apply_mean(params, self_vecs, neigh_vecs, *, act, concat,
               dropout_rate=0.0, generator=None, deterministic=True,
               shard=None):
    """``neigh_vecs`` is [n, S, d], or the pre-reduced [n, d] mean."""
    drop, reduce = _drop_and_reduce(shard)
    if neigh_vecs.dim() != 2:
        neigh_vecs = drop(generator, neigh_vecs, dropout_rate, deterministic)
    self_vecs = drop(generator, self_vecs, dropout_rate, deterministic)
    if neigh_vecs.dim() == 2:
        neigh_means = neigh_vecs
    else:
        neigh_means = _mean(neigh_vecs, 1)
    from_neighs = _dot(neigh_means, params["neigh_w"])
    from_self = _dot(self_vecs, params["self_w"])
    return _combine(from_self, from_neighs, params, act, concat, reduce)


# ----------------------------------------------------------------- gcn

def init_gcn(generator, input_dim, output_dim, model_size="small",
             bias=False, device="cpu") -> dict:
    p = {"w": glorot(generator, (input_dim, output_dim), device)}
    if bias:
        p["b"] = zeros((output_dim,), device)
    return p


def apply_gcn(params, self_vecs, neigh_vecs, *, act, concat,
              dropout_rate=0.0, generator=None, deterministic=True,
              n_samples=None, shard=None):
    """gcn never concatenates. A pre-reduced [n, d] neighbor mean over
    ``n_samples`` neighbors recombines with self as
    (S*mean + self)/(S+1)."""
    del concat
    drop, reduce = _drop_and_reduce(shard)
    if neigh_vecs.dim() != 2:
        neigh_vecs = drop(generator, neigh_vecs, dropout_rate, deterministic)
    self_vecs = drop(generator, self_vecs, dropout_rate, deterministic)
    if neigh_vecs.dim() == 2:
        means = (n_samples * neigh_vecs + self_vecs) * (
            1.0 / (n_samples + 1)
        )
    else:
        means = _mean(torch.cat([neigh_vecs, self_vecs[:, None, :]], dim=1),
                      1)
    out = _dot(means, params["w"])
    if reduce is not None:
        out = reduce(out)
    if "b" in params:
        out = out + params["b"]
    return act(out)


# ------------------------------------------------------------- pooling

def mlp_layers(params) -> list:
    """The per-neighbor MLP's layers [{"w", "b"}, ...] from the flat keys
    ``mlp.{j}.w`` and ``mlp.{j}.b``."""
    n = sum(1 for k in params if k.startswith("mlp.") and k.endswith(".w"))
    return [{"w": params[f"mlp.{j}.w"], "b": params[f"mlp.{j}.b"]}
            for j in range(n)]


def _init_pool(generator, input_dim, output_dim, hidden_dims, bias, device):
    p = {}
    d = input_dim
    for j, h in enumerate(hidden_dims):
        layer = init_dense(generator, d, h, device=device)
        p.update({f"mlp.{j}.{k}": v for k, v in layer.items()})
        d = h
    p["neigh_w"] = glorot(generator, (d, output_dim), device)
    p["self_w"] = glorot(generator, (input_dim, output_dim), device)
    if bias:
        p["b"] = zeros((output_dim,), device)
    return p


def _max_pool(h: torch.Tensor) -> torch.Tensor:
    return torch.amax(h, dim=1)


def _mean_pool(h: torch.Tensor) -> torch.Tensor:
    return h.mean(dim=1)


def _apply_pool(params, self_vecs, neigh_vecs, reduce_fn, *, act, concat,
                dropout_rate, generator, deterministic, pre_pooled=False,
                shard=None):
    """``neigh_vecs`` is [n, S, d]: the per-neighbor MLP, then the reduce
    over S; or, with ``pre_pooled``, the reduced [n, H] MLP output.
    Under ``shard`` only the MLP's first layer and the self projection
    contract the input block; the pooled rows are whole."""
    if pre_pooled:
        h = neigh_vecs
    else:
        n, s, d = neigh_vecs.shape
        h = neigh_vecs.reshape(n * s, d)
        for j, layer in enumerate(mlp_layers(params)):
            h = apply_dense(layer, h, act=torch.relu,
                            dropout_rate=dropout_rate, generator=generator,
                            deterministic=deterministic,
                            shard=shard if j == 0 else None)
        h = reduce_fn(h.view(n, s, -1))
    from_neighs = _dot(h, params["neigh_w"])
    from_self = _dot(self_vecs, params["self_w"])
    if shard is not None:
        from_self = shard.reduce(from_self)
    return _combine(from_self, from_neighs, params, act, concat)


def init_maxpool(generator, input_dim, output_dim, model_size="small",
                 bias=False, device="cpu") -> dict:
    return _init_pool(generator, input_dim, output_dim,
                      (POOL_HIDDEN[model_size],), bias, device)


def apply_maxpool(params, self_vecs, neigh_vecs, *, act, concat,
                  dropout_rate=0.0, generator=None, deterministic=True,
                  pre_pooled=False, shard=None):
    return _apply_pool(params, self_vecs, neigh_vecs, _max_pool, act=act,
                       concat=concat, dropout_rate=dropout_rate,
                       generator=generator, deterministic=deterministic,
                       pre_pooled=pre_pooled, shard=shard)


init_meanpool = init_maxpool


def apply_meanpool(params, self_vecs, neigh_vecs, *, act, concat,
                   dropout_rate=0.0, generator=None, deterministic=True,
                   pre_pooled=False, shard=None):
    return _apply_pool(params, self_vecs, neigh_vecs, _mean_pool, act=act,
                       concat=concat, dropout_rate=dropout_rate,
                       generator=generator, deterministic=deterministic,
                       pre_pooled=pre_pooled, shard=shard)


def init_twomaxpool(generator, input_dim, output_dim, model_size="small",
                    bias=False, device="cpu") -> dict:
    return _init_pool(generator, input_dim, output_dim,
                      TWOPOOL_HIDDEN[model_size], bias, device)


def apply_twomaxpool(params, self_vecs, neigh_vecs, *, act, concat,
                     dropout_rate=0.0, generator=None, deterministic=True,
                     shard=None):
    return _apply_pool(params, self_vecs, neigh_vecs, _max_pool, act=act,
                       concat=concat, dropout_rate=dropout_rate,
                       generator=generator, deterministic=deterministic,
                       shard=shard)


# ----------------------------------------------------------------- seq

def init_seq(generator, input_dim, output_dim, model_size="small",
             bias=False, device="cpu") -> dict:
    hidden = LSTM_HIDDEN[model_size]
    p = {f"lstm.{k}": v for k, v in
         init_lstm(generator, input_dim, hidden, device).items()}
    p["neigh_w"] = glorot(generator, (hidden, output_dim), device)
    p["self_w"] = glorot(generator, (input_dim, output_dim), device)
    if bias:
        p["b"] = zeros((output_dim,), device)
    return p


def apply_seq(params, self_vecs, neigh_vecs, *, act, concat,
              dropout_rate=0.0, generator=None, deterministic=True,
              shard=None):
    """``neigh_vecs`` [n, S, d]: the LSTM's output at each sequence's
    last non-zero row, then the neighbor projection."""
    del dropout_rate, generator, deterministic
    _, reduce = _drop_and_reduce(shard)
    lstm = {"kernel": params["lstm.kernel"], "bias": params["lstm.bias"]}
    neigh_h = lstm_last_output(lstm, neigh_vecs,
                               neighbor_lengths(neigh_vecs, shard),
                               reduce=reduce)
    from_neighs = _dot(neigh_h, params["neigh_w"])
    from_self = _dot(self_vecs, params["self_w"])
    if reduce is not None:
        from_self = reduce(from_self)
    return _combine(from_self, from_neighs, params, act, concat)


# ------------------------------------------------------------ registry

AGGREGATORS = {
    "mean": (init_mean, apply_mean),
    "gcn": (init_gcn, apply_gcn),
    "maxpool": (init_maxpool, apply_maxpool),
    "meanpool": (init_meanpool, apply_meanpool),
    "twomaxpool": (init_twomaxpool, apply_twomaxpool),
    "seq": (init_seq, apply_seq),
}


def _lookup(name):
    if name not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}")
    return AGGREGATORS[name]


def init_aggregator(name, generator, input_dim, output_dim,
                    model_size="small", bias=False, device="cpu") -> dict:
    return _lookup(name)[0](generator, input_dim, output_dim,
                            model_size=model_size, bias=bias, device=device)


def apply_aggregator(name, params, self_vecs, neigh_vecs, **kw):
    return _lookup(name)[1](params, self_vecs, neigh_vecs, **kw)


def decay_weights(name, params) -> list:
    """The weights weight decay applies to: the aggregator's own
    self/neigh projections (gcn's single weight) and bias, never the
    pooling MLP or the LSTM."""
    _lookup(name)
    return [params[k] for k in ("w", "neigh_w", "self_w", "b") if k in params]
