"""The GraphSAGE core: fanout sampling + the hop-pyramid aggregation fold.

Frontier order: with layers [(S1, d1), (S2, d2)], the *first* expansion
samples S2 neighbors of the batch and the second samples S1 neighbors of
those, so the flat frontiers have sizes [B], [B*S2], [B*S2*S1]. The
pyramid folds from the outside in, reusing one aggregator's parameters
across all hops of a layer. The innermost hop, the one the fused
gather-mean reduces, therefore has fanout ``fanouts[0]``.

With ``concat=True`` every layer output is 2x its nominal output_dim and
doubles all later input dims; the last layer uses the identity
activation.

Parameters are a flat dict of tensors keyed by the JAX pytree's paths:
``aggs.{i}.{neigh_w,self_w,w,b}``, the pooling MLP's
``aggs.{i}.mlp.{j}.{w,b}``, the seq aggregator's
``aggs.{i}.lstm.{kernel,bias}`` and ``embeds`` (see ``params.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from graphsage_tpu_torch.nn.aggregators import (
    apply_aggregator,
    decay_weights,
    init_aggregator,
    mlp_layers,
)
from graphsage_tpu_torch.nn.init import glorot
from graphsage_tpu_torch.nn.sampler import uniform_sample
from graphsage_tpu_torch.ops.gather import (
    fused_gather_mean,
    fused_gather_rows,
)
from graphsage_tpu_torch.ops.philox import philox_dropout
from graphsage_tpu_torch.ops.pool import gather_mlp_pool_train

# Tags (the last counter word of the Philox streams) of the two masks of
# the fused innermost hop, the JAX package's fold_in tags: K2 (or K6 for
# meanpool) masks the feature columns of the neighbor rows, the identity
# tag the identity columns of the same rows.
KERNEL_DROP_TAG = 0x5EED
IDENTITY_DROP_TAG = 0x1D


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Per-layer fanout + output dim."""

    num_samples: int
    output_dim: int


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    layers: tuple          # tuple[LayerInfo, ...]
    feature_dim: int       # raw feature dim (0 in featureless mode)
    aggregator: str = "mean"
    concat: bool = True
    model_size: str = "small"
    identity_dim: int = 0  # >0 adds a trainable [N+1, id_dim] table
    num_nodes: int = 0     # N (for the identity table; row N is the dummy)
    dropout: float = 0.0
    sampler_mode: str = "shared_perm"
    fused_gather: bool = False  # CUDA kernel for the innermost hop
    dedup_gather: bool = False  # K3: the fused mean loads distinct rows once
    rows_gather: bool = False   # K4 gathers the innermost hop's rows
    shard_layout: str = "strided"  # row ownership under --graph_shards

    @property
    def input_dim(self) -> int:
        return self.feature_dim + self.identity_dim

    @property
    def dims(self) -> tuple:
        """[input_dim, d1, d2, ...]."""
        return (self.input_dim,) + tuple(li.output_dim for li in self.layers)

    @property
    def fanouts(self) -> tuple:
        return tuple(li.num_samples for li in self.layers)

    @property
    def output_dim(self) -> int:
        mult = 2 if self.concat else 1
        return mult * self.layers[-1].output_dim

    def agg_input_dim(self, layer: int) -> int:
        mult = 2 if self.concat and layer != 0 else 1
        return mult * self.dims[layer]


def agg_params(params: dict, layer: int) -> dict:
    """One layer's aggregator parameters, keyed by their leaf names."""
    prefix = f"aggs.{layer}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def init_sage_params(generator: torch.Generator, config: SAGEConfig,
                     device="cpu") -> dict:
    """Flat parameter dict: every layer's aggregator, then ``embeds``."""
    params = {}
    for layer in range(len(config.layers)):
        p = init_aggregator(
            config.aggregator, generator, config.agg_input_dim(layer),
            config.dims[layer + 1], model_size=config.model_size,
            device=device,
        )
        params.update({f"aggs.{layer}.{k}": v for k, v in p.items()})
    if config.identity_dim > 0:
        params["embeds"] = glorot(
            generator, (config.num_nodes + 1, config.identity_dim), device
        )
    return params


def sample_frontier(generator, adj, ids, fanouts: Sequence[int],
                    mode: str = "shared_perm") -> list:
    """Expand the fanout pyramid: flat index tensors
    [B], [B*S_k], [B*S_k*S_{k-1}], ..."""
    n_layers = len(fanouts)
    samples = [ids]
    for k in range(n_layers):
        nxt = uniform_sample(generator, adj, samples[k],
                             fanouts[n_layers - k - 1], mode=mode)
        samples.append(nxt.reshape(-1))
    return samples


def gather_features(params, features, idx, config: SAGEConfig):
    """Rows of one frontier: [identity embedding | features], in the
    table's dtype (a bf16 table's rows stay bf16, as ``jnp.take``
    keeps them; with an identity table ``torch.cat`` promotes to f32)."""
    parts = []
    if config.identity_dim > 0:
        parts.append(params["embeds"].index_select(0, idx))
    if features is not None and config.feature_dim > 0:
        parts.append(features.index_select(0, idx))
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=1)


def aggregate_pyramid(params, hidden: list, batch_size: int,
                      config: SAGEConfig, generator=None,
                      deterministic: bool = True,
                      last_hop_neigh_mean=None,
                      capture: dict | None = None):
    """Fold the hop pyramid; ``hidden[h]`` holds frontier h's rows.

    ``capture``: a dict that receives the batch's input rows
    (``acts/input``) and each aggregator call's output
    (``acts/layer_<L>/hop_<H>``), for ``--log_histograms``.

    ``last_hop_neigh_mean``: optional pre-reduced input for the
    innermost hop (layer 0's last aggregator call): the [B*support, F]
    mean of the fused gather-mean, or for meanpool the [B*support, H]
    pooled MLP output of the fused gather-MLP-pool; ``hidden[-1]`` is
    then None.
    """
    n_layers = len(config.layers)
    fanouts = config.fanouts
    dims = config.dims

    support = [1]
    for k in range(n_layers):
        support.append(support[-1] * fanouts[n_layers - k - 1])

    if capture is not None and hidden[0] is not None:
        capture["acts/input"] = hidden[0]
    for layer in range(n_layers):
        layer_params = agg_params(params, layer)
        is_last = layer == n_layers - 1
        act = (lambda x: x) if is_last else torch.relu
        dim_mult = 2 if config.concat and layer != 0 else 1
        next_hidden = []
        for hop in range(n_layers - layer):
            extra = {}
            if (layer == 0 and hop == n_layers - 1
                    and last_hop_neigh_mean is not None):
                neigh = last_hop_neigh_mean
                if config.aggregator == "gcn":
                    extra = {"n_samples": fanouts[0]}
                elif config.aggregator == "meanpool":
                    extra = {"pre_pooled": True}
            else:
                neigh = hidden[hop + 1].reshape(
                    batch_size * support[hop],
                    fanouts[n_layers - hop - 1],
                    dim_mult * dims[layer],
                )
            h = apply_aggregator(
                config.aggregator, layer_params, hidden[hop], neigh,
                act=act, concat=config.concat,
                dropout_rate=config.dropout, generator=generator,
                deterministic=deterministic, **extra,
            )
            if capture is not None:
                capture[f"acts/layer_{layer}/hop_{hop}"] = h
            next_hidden.append(h)
        hidden = next_hidden
    return hidden[0]


def sage_embed(params, features, adj, ids, config: SAGEConfig,
               generator: torch.Generator | None = None,
               deterministic: bool = True,
               drop_key: tuple[int, int] | None = None,
               capture: dict | None = None):
    """Sample -> gather -> aggregate: [B] ids -> [B, out] raw
    (un-normalized) embeddings. ``generator`` (on ``adj``'s device)
    drives the sampler and, when not ``deterministic``, dropout;
    ``capture`` receives the activations (``aggregate_pyramid``).

    The innermost hop's routes, as in the JAX package:
    - ``fused_gather`` with mean or gcn: ``fused_gather_mean`` reduces
      the hop (f32 mean; K3, each distinct row loaded once, with
      ``dedup_gather`` and no dropout), and an identity table's columns
      of those rows take a plain gather and mean beside it (the kernel
      reads only the feature table);
    - ``fused_gather`` with meanpool and no identity table (the MLP
      mixes all columns): ``gather_mlp_pool_train`` runs the hop's
      gather, first MLP layer and mean pool;
    - ``rows_gather`` when neither took the hop (maxpool, twomaxpool,
      seq, or any aggregator without ``fused_gather``):
      ``fused_gather_rows`` (K4) gathers the hop's feature rows, and an
      identity table's columns stay on a differentiable ``index_select``
      in front of them, ``[identity | features]``;
    - otherwise the plain gather.
    Training with dropout draws the fused hop's masks from Philox
    streams: ``drop_key`` = (seed, step), host integers, with the tags
    above, so each step's masks differ and nothing is read back.
    """
    samples = sample_frontier(generator, adj, ids, config.fanouts,
                              mode=config.sampler_mode)
    has_features = features is not None and config.feature_dim > 0
    fused = (config.fused_gather and config.aggregator in ("mean", "gcn")
             and has_features)
    pool_fused = (config.fused_gather and config.aggregator == "meanpool"
                  and has_features and config.identity_dim == 0)
    use_rows = config.rows_gather and has_features and not (
        fused or pool_fused)
    inner_fanout = config.fanouts[0]
    idx2 = samples[-1].reshape(-1, inner_fanout)
    last_mean = last_rows = None
    if fused or pool_fused:
        inner_drop = 0.0 if deterministic else config.dropout
        if inner_drop > 0.0 and drop_key is None:
            raise ValueError(
                "training the fused path with dropout needs drop_key=(seed, "
                "step) for the in-kernel mask"
            )
        seed, step = drop_key if inner_drop > 0.0 else (None, 0)
        offset = (step, KERNEL_DROP_TAG) if inner_drop > 0.0 else None
    if pool_fused:
        mlp0 = mlp_layers(agg_params(params, 0))[0]
        last_mean = gather_mlp_pool_train(
            features, idx2, mlp0["w"], mlp0["b"], "mean",
            drop_rate=inner_drop, seed=seed, offset=offset,
        )
    elif fused:
        last_mean = fused_gather_mean(
            features, idx2, drop_rate=inner_drop, seed=seed, offset=offset,
            dedup=config.dedup_gather,
        )
        if config.identity_dim > 0:
            id_rows = params["embeds"].index_select(0, samples[-1])
            if inner_drop > 0.0:
                id_rows = philox_dropout(id_rows, inner_drop, seed, step,
                                         IDENTITY_DROP_TAG)
            id_mean = id_rows.view(-1, inner_fanout,
                                   config.identity_dim).mean(dim=1)
            last_mean = torch.cat([id_mean, last_mean], dim=1)
    elif use_rows:
        last_rows = fused_gather_rows(features, idx2)
        if config.identity_dim > 0:
            last_rows = torch.cat(
                [params["embeds"].index_select(0, samples[-1]), last_rows],
                dim=1)
    # the innermost frontier's rows take the plain gather only when no
    # kernel reduced or gathered them
    inner_done = last_mean is not None or last_rows is not None
    hidden = [gather_features(params, features, s, config)
              for s in (samples[:-1] if inner_done else samples)]
    if inner_done:
        hidden.append(last_rows)
    return aggregate_pyramid(
        params, hidden, ids.shape[0], config,
        generator=None if deterministic else generator,
        deterministic=deterministic, last_hop_neigh_mean=last_mean,
        capture=capture,
    )


def sage_decay_weights(params, config: SAGEConfig) -> list:
    """Weights subject to weight decay: each aggregator's projections."""
    out = []
    for layer in range(len(config.layers)):
        out.extend(decay_weights(config.aggregator,
                                 agg_params(params, layer)))
    return out


def l2_normalize(x, dim=1, eps=1e-12):
    """tf.nn.l2_normalize semantics."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True),
                                      min=eps))
