"""Feature-dim tensor parallelism (``--n_model_shards M``): the
counterpart of the JAX package's ("data", "model") mesh
(``parallel/mesh.py``) and of ``sage_param_shardings(tp=True)`` and the
``place_*`` helpers (``parallel/dp.py:312-357``).

The JAX package places the feature table split on its feature axis and
the layer-0 weights split on their contracting axis, and GSPMD inserts
the contraction's all-reduce. Here each of a data slice's M ranks (its
model group, ``distributed.Grid``) holds

- a contiguous block of the F feature columns and of the identity
  table's columns (``column_blocks``: the blocks lie on 4-column
  boundaries, so that no Philox group of K2's mask straddles two ranks);
- the matching rows of every weight that contracts the raw input
  (``split_params``, chosen by role: layer 0's neighbor and self
  projections, gcn's shared one, the pooling MLP's first layer and the
  LSTM's input rows), two blocks of rows when an identity table leads
  the input;
- everything else whole, replicated on every rank.

The innermost mean is per column, so the gather-mean kernels (K1, K2,
K3) and the row gather (K4) run unchanged on a rank's block; only the
layer-0 products are partial sums, which ``reduce_from_model`` adds
over the model group before their bias and activation. Every later
activation is then the same on the model group's ranks, and so is every
gradient of a replicated parameter: the gradients are summed over the
data group only (``distributed.all_reduce_grads``). A shard's gradient
is the matching rows of the whole gradient, and the clipped Adam update
is per element, so each rank's shard moves as the whole parameter's
rows move on one device.

``ModelShard`` is what the model's layer 0 takes (``shard=``): the
reduce, the plain dropout of block inputs (the full-width mask, drawn
from the shared generator, its columns kept: every rank's generator
advances as one device's) and the row maxima that the LSTM's lengths
need. A checkpoint holds the whole params and Adam moments
(``gather_whole``, the chief writes), so it loads on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from graphsage_tpu_torch.parallel.distributed import fold_seed

POOLING = ("maxpool", "meanpool", "twomaxpool")
# layer 0's weights that contract the raw input, by aggregator
_SPLIT_KEYS = {"mean": ("neigh_w", "self_w"), "gcn": ("w",),
               "seq": ("self_w",)}
_SPLIT_KEYS.update({name: ("mlp.0.w", "self_w") for name in POOLING})


def column_blocks(width: int, n: int) -> list:
    """The ``n`` contiguous [lo, hi) blocks of ``width`` columns: the
    ceil(width / 4) four-column groups split as evenly as they go, the
    larger shares first, the last block cut at ``width``. F = 602 gives
    304 + 298 at n = 2 and 152, 152, 152, 146 at n = 4."""
    if n < 1:
        raise ValueError(f"n_model_shards must be >= 1, got {n}")
    q, r = divmod(-(-width // 4), n)
    blocks, lo = [], 0
    for m in range(n):
        hi = min(width, lo + 4 * (q + (m < r)))
        blocks.append((lo, hi))
        lo = hi
    return blocks


def input_rows(sage_config, n: int, m: int) -> np.ndarray:
    """The rows of layer 0's input ([identity | features], ``input_dim``
    wide) that rank ``m`` of ``n`` holds: its identity block, then its
    feature block."""
    (ilo, ihi), (flo, fhi) = (column_blocks(sage_config.identity_dim, n)[m],
                              column_blocks(sage_config.feature_dim, n)[m])
    return np.concatenate([np.arange(ilo, ihi), sage_config.identity_dim
                           + np.arange(flo, fhi)]).astype(np.int64)


def split_params(sage_config) -> dict:
    """key -> (dim, kind) of every parameter that is split: "rows", the
    input rows of a weight [input_dim, out]; "lstm", the LSTM kernel
    [input_dim + H, 4H], its input rows split and its recurrent rows
    kept whole on every rank; "cols", the identity table's columns.
    Chosen by role: a layer-0 weight whose first dim happens to equal
    ``input_dim`` but contracts something else (a pooling MLP's second
    layer, the neighbor projection after the pool) stays whole."""
    if sage_config.aggregator not in _SPLIT_KEYS:
        raise ValueError(f"unknown aggregator {sage_config.aggregator!r}")
    out = {f"aggs.0.{k}": (0, "rows")
           for k in _SPLIT_KEYS[sage_config.aggregator]}
    if sage_config.aggregator == "seq":
        out["aggs.0.lstm.kernel"] = (0, "lstm")
    if sage_config.identity_dim > 0:
        out["embeds"] = (1, "cols")
    return out


def shard_index(sage_config, kind: str, whole_len: int, n: int,
                m: int) -> np.ndarray:
    """The indices, along its split dim, of rank ``m``'s shard of a
    parameter ``whole_len`` long there."""
    if kind == "cols":
        lo, hi = column_blocks(sage_config.identity_dim, n)[m]
        return np.arange(lo, hi, dtype=np.int64)
    rows = input_rows(sage_config, n, m)
    if kind == "lstm":
        rows = np.concatenate([rows, np.arange(sage_config.input_dim,
                                               whole_len, dtype=np.int64)])
    return rows


def tp_seed(seed: int, grid) -> int:
    """The seed of a rank's sampler and dropout draws under tensor
    parallelism: every rank of a model group draws alike (its replicated
    activations must take the same samples and masks, or the replicas
    part after one step), so the seed is folded with the data index
    only, and not at all with one data slice, where the run draws as one
    device does."""
    return seed if grid.data_size == 1 else fold_seed(seed, grid.data_rank)


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward, identity backward: every rank
    of the group holds the same downstream gradient, which is already
    the gradient of each partial product. (``torch.distributed.nn``'s
    ``all_reduce`` would sum that gradient over the group too, scaling
    each shard's gradient by M.)"""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model ``group``; its gradient passes as
    it is."""
    return _ReduceFromModel.apply(x, group)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Rank ``rank`` of a model group of ``size``: its blocks of the
    input columns and what layer 0 does on them."""

    size: int
    rank: int
    group: object
    sage_config: object

    @classmethod
    def of(cls, sage_config, grid) -> ModelShard:
        return cls(grid.model_size, grid.model_rank, grid.model_group,
                   sage_config)

    @property
    def feat_block(self) -> tuple:
        return column_blocks(self.sage_config.feature_dim,
                             self.size)[self.rank]

    @property
    def id_block(self) -> tuple:
        return column_blocks(self.sage_config.identity_dim,
                             self.size)[self.rank]

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_model(x, self.group)

    def dropout(self, generator, x: torch.Tensor, rate: float,
                deterministic: bool) -> torch.Tensor:
        """``nn/init.py::dropout`` of a block of layer 0's input: the mask
        of the whole row is drawn and the block's columns kept, so the
        generator advances as one device's and the block is dropped as
        one device drops those columns."""
        if deterministic or rate == 0.0:
            return x
        full = self.sage_config.input_dim
        keep = 1.0 - rate
        mask = torch.rand(x.shape[:-1] + (full,), generator=generator,
                          device=x.device) < keep
        if x.shape[-1] != full:
            cols = torch.from_numpy(input_rows(self.sage_config, self.size,
                                               self.rank)).to(x.device)
            mask = mask.index_select(-1, cols)
        keep_x = float(torch.tensor(keep, dtype=x.dtype))
        return torch.where(mask, x / keep_x, torch.zeros_like(x))

    def row_max_abs(self, x: torch.Tensor) -> torch.Tensor:
        """The largest |element| of each whole row of ``x`` [..., d_m]
        (a max over the model group), f32, out of the autograd graph."""
        with torch.no_grad():
            if x.shape[-1]:
                local = torch.linalg.vector_norm(x.float(), ord=float("inf"),
                                                 dim=-1)
            else:
                local = x.new_zeros(x.shape[:-1], dtype=torch.float32)
            dist.all_reduce(local, op=dist.ReduceOp.MAX, group=self.group)
        return local


def decay_term(params: dict, decayed: list, weight_decay: float,
               shard: ModelShard) -> torch.Tensor:
    """weight_decay * sum 0.5 |w|^2 over ``decayed`` (tensors of
    ``params``), a shard's squares summed over the model group: every
    rank holds the whole term, and a shard's gradient stays its own."""
    split = {id(params[k]) for k in split_params(shard.sage_config)
             if k in params}
    whole = sum(0.5 * (w * w).sum() for w in decayed if id(w) not in split)
    parts = [0.5 * (w * w).sum() for w in decayed if id(w) in split]
    if parts:
        whole = whole + shard.reduce(sum(parts))
    return weight_decay * whole


def _gathered(t: torch.Tensor, dim: int, group, size: int) -> list:
    """Every group rank's ``t`` in rank order; their lengths along
    ``dim`` may differ (padded to the longest for the gather, cut back
    after)."""
    gloo = dist.get_backend(group) == "gloo"
    n = torch.tensor([t.shape[dim]], device="cpu" if gloo else t.device)
    lens = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(lens, n, group=group)
    lens = [int(k) for k in lens]
    pad = list(t.shape)
    pad[dim] = max(lens) - t.shape[dim]
    src = torch.cat([t, t.new_zeros(pad)], dim=dim).contiguous()
    if gloo:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.narrow(dim, 0, k).to(t.device) for p, k in zip(parts, lens)]


def gather_whole(tree: dict, shard: ModelShard) -> dict:
    """The whole tensors of a rank's ``tree`` (params, or one Adam
    moment, keyed as the params), its shards gathered over the model
    group (a collective call) and put together by
    ``params.py::params_from_model_shards``."""
    from graphsage_tpu_torch.params import params_from_model_shards

    split = [k for k in split_params(shard.sage_config) if k in tree]
    parts = {k: _gathered(tree[k].detach(), split_params(
        shard.sage_config)[k][0], shard.group, shard.size) for k in split}
    whole = params_from_model_shards(
        [{k: parts[k][m] for k in split} for m in range(shard.size)],
        shard.sage_config)
    return dict(tree, **whole)
