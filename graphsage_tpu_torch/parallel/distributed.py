"""Process groups for the multi-device paths: one process per device.

The JAX package runs one process per host and lays its devices out in a
mesh whose ``data`` and ``graph`` axes carry the collectives. Here every
device has a process of its own (a rank), and ``torch.distributed``
process groups take the place of the mesh axes:

- a **graph group** per data slice: the ranks that row-shard the tables
  between them and exchange frontier rows (``graph_sharded.py``);
- a **data group** per graph index: the ranks that hold the same shard
  in different data slices (pure data parallelism across them);
- a **model group** per data slice under tensor parallelism
  (``--n_model_shards``, ``tensor.py``): the ranks that hold column
  blocks of one copy of the feature table and reduce the layer-0
  products between them;
- the whole world, over which the loss and the replicated parameters'
  gradients are summed (under tensor parallelism: the data group).

Ranks are laid out data-major, as the JAX package's ``_composed_me``
(``graph_sharded.py:350-370``) lays out ``P(("data", "graph"))`` rows
and its ``make_mesh`` reshapes its devices to ("data", "model")
(``parallel/mesh.py:37``): rank ``(d * G + g) * M + m`` is graph shard
``g`` and model shard ``m`` of data slice ``d`` (graph and model
sharding do not compose: one of G and M is 1), so the world's rank
order is the order in which per-rank batch rows stack.

Start-up (``init_distributed``) takes an explicit store address, world
size and rank: a ``tcp://host:port`` coordinator across hosts, a
``file://`` store on one host, or ``env://`` under ``torchrun``. NCCL
serves CUDA ranks (rank r on ``cuda:{local_rank}``), gloo the CPU.
``parallel/launch.py`` starts the ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the data x graph (or data x model) grid, and
    its groups.

    ``graph_size`` ranks share one copy of the row-sharded tables, or
    ``model_size`` ranks one copy of the column-split ones; ``data_size``
    such slices split each batch between them.
    """

    graph_size: int
    data_size: int
    graph_rank: int
    data_rank: int
    graph_group: object
    data_group: object
    model_size: int = 1
    model_rank: int = 0
    model_group: object = None

    @property
    def total(self) -> int:
        """The batch's splits (a model group takes one split whole)."""
        return self.graph_size * self.data_size

    @property
    def me(self) -> int:
        """The composed, data-major index: this rank's batch split."""
        return self.data_rank * self.graph_size + self.graph_rank

    @property
    def is_chief(self) -> bool:
        """Rank 0 writes logs, stats and checkpoints."""
        return self.me == 0 and self.model_rank == 0


def init_distributed(init_method: str, world_size: int, rank: int,
                     device: torch.device,
                     backend: str | None = None) -> None:
    """Join the process group: NCCL for a CUDA ``device`` (bound first
    with ``torch.cuda.set_device``), gloo for the CPU, unless
    ``backend`` says otherwise."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_grid(graph_shards: int, data_shards: int,
              model_shards: int = 1) -> Grid:
    """This rank's ``Grid`` over the initialised world, which must hold
    exactly ``graph_shards * data_shards * model_shards`` ranks. Every
    rank calls it: creating a group is a collective call, made for every
    group in the same order on every rank."""
    G, Dd, M = graph_shards, data_shards, model_shards
    what = (f"--graph_shards {G} x --data_shards {Dd}"
            + (f" x --n_model_shards {M}" if M > 1 else ""))
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a process group: start it through `python -m "
            "graphsage_tpu_torch`, torchrun or parallel/launch.py")
    if G > 1 and M > 1:
        raise ValueError(f"{what}: graph and model sharding do not compose")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != G * Dd * M:
        raise ValueError(
            f"the process group has {world} ranks but {what} needs "
            f"{G * Dd * M}")

    def rank_of(d, g, m):
        return (d * G + g) * M + m

    graph_groups = {(d, m): dist.new_group([rank_of(d, g, m)
                                            for g in range(G)])
                    for d in range(Dd) for m in range(M)}
    data_groups = {(g, m): dist.new_group([rank_of(d, g, m)
                                           for d in range(Dd)])
                   for g in range(G) for m in range(M)}
    model_groups = {(d, g): dist.new_group([rank_of(d, g, m)
                                            for m in range(M)])
                    for d in range(Dd) for g in range(G)}
    (d, g), m = divmod(rank // M, G), rank % M
    return Grid(graph_size=G, data_size=Dd, graph_rank=g, data_rank=d,
                graph_group=graph_groups[d, m], data_group=data_groups[g, m],
                model_size=M, model_rank=m, model_group=model_groups[d, g])


def fold_seed(seed: int, me: int) -> int:
    """A 63-bit seed of rank ``me``'s own, derived from ``seed``: the
    counterpart of ``jax.random.fold_in(rng, me)``, so the ranks' dropout
    masks and sampler draws differ. Only the non-deterministic modes
    consume it."""
    word = np.random.SeedSequence([seed, me]).generate_state(1, np.uint64)
    return int(word[0] >> np.uint64(1))


def host_array(t: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``t`` stacked along dim 0 in group rank order, as one
    host array on every rank (the JAX package's ``host_array`` of a
    batch-split output). A gloo group gathers host copies."""
    t = t.detach()
    if dist.get_backend(group) == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts).cpu().numpy()


def all_reduce_grads(params: dict, grid: Grid,
                     extra: torch.Tensor | None = None):
    """Sum the gradients of the step: every replicated parameter's over
    the world, in one flattened bucket, and the identity table's
    (``embeds``) over the data group only. Within a graph group that
    table is row-sharded, and the exchange's backward has already sent
    each row's gradient to its owner; under pure data parallelism the
    data group is the world. Under tensor parallelism (model groups of
    more than one rank) every gradient, a shard's included, is summed
    over the data group only: the ranks of a model group hold the same
    gradient of a replicated parameter, and each its own shard's rows of
    the whole gradient (``tensor.py``); with one data slice nothing is
    summed. A parameter without a gradient counts as zeros, as optax
    steps every leaf. ``extra``, a 1-D float32 tensor, rides the same
    bucket (the unsupervised runners' MRR sums, which then cost no
    collective of their own) and is returned summed over the world;
    without it the call returns None."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tp = grid.model_size > 1
    shared = [p for k, p in params.items() if tp or k != "embeds"]
    flat = torch.cat([p.grad.reshape(-1) for p in shared]
                     + ([] if extra is None else [extra]))
    if not tp:
        dist.all_reduce(flat)
    elif grid.data_size > 1:
        dist.all_reduce(flat, group=grid.data_group)
    offset = 0
    for p in shared:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    if "embeds" in params and grid.data_size > 1 and not tp:
        dist.all_reduce(params["embeds"].grad, group=grid.data_group)
    return None if extra is None else flat[offset:]
