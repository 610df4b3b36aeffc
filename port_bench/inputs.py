"""A run's inputs, made on its device from ``--seed``: the graph, the
labels and the initial weights, each from a stream of its own.

- The adjacency is ``max_degree`` neighbours a row drawn i.i.d. from a
  zipf(``alpha``) law over degree-ordered ids (id 0 the biggest hub),
  the law of the JAX package's ``bench.py`` (its ``zipf_adjacency``),
  drawn here by inverse CDF on the card; row N, the dummy, points at
  itself, as the port pads.
- Features are standard normals, with the zero dummy row N; labels
  uniform classes, as a one-hot table of N + 1 rows (the dummy's zero).
- Weights are glorot-uniform (limit sqrt(6 / (fan_in + fan_out))) from
  one draw of uniforms for all of them, biases zero.

A configuration that states ``graph_shards`` > 1 gives each rank only
its shard of the tables (``make_shard``), in the port's device layout
(``shard_layout``: ``strided``, local row r of shard d holds node
r * D + d, or ``block``, node d * ss + r; rows past the dummy are
zero), made on the rank's own card. The laws are the same, but each
element is a pure function of (the seed's ``GRAPH`` stream, row,
column), a counter-based hash, so that a shard is made without the
rest of the table and ``feature_rows``, ``adjacency_rows`` and
``label_rows`` make any rows again on any device: they are how a
sharded cell's reference gets its rows. Labels are class ids, every
row on every rank, the dummy's -1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference.sage import glorot_limit, param_shapes

# streams of one seed
GRAPH, WEIGHTS, SAMPLER, TRAFFIC, CHECK = range(5)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run seeded ``seed``."""
    state = np.random.SeedSequence([seed, stream]).generate_state(
        2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


@dataclasses.dataclass
class Graph:
    num_nodes: int
    features: torch.Tensor      # [N + 1, F] float32
    adj: torch.Tensor           # [N + 1, max_degree] int32
    labels_table: torch.Tensor  # [N + 1, C] float32, one-hot


def make_graph(cfg: dict, seed: int, device) -> Graph:
    n, f, c, d = (cfg["num_nodes"], cfg["feature_dim"], cfg["num_classes"],
                  cfg["max_degree"])
    gen = generator(seed, GRAPH, device)
    features = torch.empty((n + 1, f), dtype=torch.float32, device=device)
    features[:n].normal_(generator=gen)
    features[n] = 0.0
    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -cfg["graph"]["alpha"], dim=0)
    u = torch.rand(n * d, generator=gen, dtype=torch.float64, device=device)
    draws = torch.searchsorted(cdf, u * cdf[-1], right=True)
    adj = torch.full((n + 1, d), n, dtype=torch.int32, device=device)
    adj[:n] = draws.clamp_(max=n - 1).view(n, d)
    del ranks, cdf, u, draws
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    labels_table = torch.zeros((n + 1, c), dtype=torch.float32,
                               device=device)
    labels_table[torch.arange(n, device=device), labels] = 1.0
    return Graph(n, features, adj, labels_table)


def make_params(cfg: dict, seed: int, device) -> dict:
    shapes = param_shapes(cfg)
    weights = [k for k in shapes if not k.endswith(".b")]
    sizes = [int(np.prod(shapes[k])) for k in weights]
    u = torch.rand(sum(sizes), generator=generator(seed, WEIGHTS, device),
                   device=device)
    params = {}
    for k, part in zip(weights, torch.split(u, sizes)):
        params[k] = ((2.0 * part - 1.0) * glorot_limit(shapes[k])).view(
            shapes[k])
    for k, shape in shapes.items():
        if k.endswith(".b"):
            params[k] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return {k: params[k] for k in shapes}


# ------------------------------------------------------- sharded inputs

M32 = 0xFFFFFFFF
MIX = 0x45D9F3B          # odd and under 2**27: products stay in int64
CHUNK = 1 << 24          # elements made at once
# the hash's domains: a feature's two uniforms, an adjacency entry's two
# halves of 53 bits, a label
FEAT_U1, FEAT_U2, ADJ_HI, ADJ_LO, LABEL = range(5)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A bijection of 32-bit values held in int64, in place."""
    for _ in range(2):
        x.bitwise_xor_(x >> 16).mul_(MIX).bitwise_and_(M32)
    return x.bitwise_xor_(x >> 16)


def _keys(seed: int) -> tuple:
    key = stream_seed(seed, GRAPH)
    return key & M32, key >> 32


def _hash(seed: int, ids: torch.Tensor, cols: int, domain: int):
    """[len(ids), cols] uniform 32-bit values (int64) of the elements
    (id, column) in ``domain``."""
    k0, k1 = _keys(seed)
    a = _mix(ids.to(torch.int64).bitwise_xor(k0))
    b = _mix(a.bitwise_xor(k1))
    col = torch.arange(cols, dtype=torch.int64, device=ids.device)
    x = _mix(a[:, None].bitwise_xor(col.bitwise_or(domain << 20)))
    return _mix(x.bitwise_xor_(b[:, None]))


def shards(cfg: dict) -> int:
    return cfg.get("graph_shards", 1)


def shard_size(cfg: dict) -> int:
    """Rows a shard holds: the N + 1 rows (the dummy last) over the
    shards, rounded up."""
    return -(-(cfg["num_nodes"] + 1) // shards(cfg))


def shard_ids(cfg: dict, index: int, device) -> torch.Tensor:
    """The node id each local row of shard ``index`` holds (N and above:
    the dummy, then zero rows)."""
    d, ss = shards(cfg), shard_size(cfg)
    local = torch.arange(ss, dtype=torch.int64, device=device)
    if cfg.get("shard_layout", "strided") == "strided":
        return local * d + index
    return local + index * ss


def zipf_cdf(cfg: dict, device) -> torch.Tensor:
    """The unnormalised cumulative zipf(alpha) law over ids 0 .. N-1,
    summed on the host in order: the card's parallel scan rounds by
    timing, and every rank and every reference has to draw from the same
    bits."""
    weights = torch.arange(1, cfg["num_nodes"] + 1, dtype=torch.float64,
                           device=device).pow_(-cfg["graph"]["alpha"])
    return torch.from_numpy(np.cumsum(weights.cpu().numpy())).to(device)


def _chunks(ids: torch.Tensor, width: int):
    step = max(1, CHUNK // width)
    for a in range(0, ids.shape[0], step):
        yield a, ids[a:a + step]


def _features_into(out, cfg, seed, ids) -> None:
    n = cfg["num_nodes"]
    for a, part in _chunks(ids, out.shape[1]):
        u1 = (_hash(seed, part, out.shape[1], FEAT_U1) >> 8).add_(1).to(
            torch.float32).mul_(2.0 ** -24)
        u2 = (_hash(seed, part, out.shape[1], FEAT_U2) >> 8).to(
            torch.float32).mul_(2.0 ** -24)
        z = u1.log_().mul_(-2.0).sqrt_().mul_(
            u2.mul_(2.0 * np.pi).cos_())
        z[part >= n] = 0.0
        out[a:a + part.shape[0]] = z


def _adjacency_into(out, cfg, seed, ids, cdf) -> None:
    n = cfg["num_nodes"]
    for a, part in _chunks(ids, out.shape[1]):
        hi = _hash(seed, part, out.shape[1], ADJ_HI) >> 5
        lo = _hash(seed, part, out.shape[1], ADJ_LO) >> 6
        u = hi.mul_(1 << 26).add_(lo).to(torch.float64).mul_(2.0 ** -53)
        draws = torch.searchsorted(cdf, u.mul_(cdf[-1]), right=True)
        draws.clamp_(max=n - 1)
        draws[part == n] = n
        draws[part > n] = 0
        out[a:a + part.shape[0]] = draws


def feature_rows(cfg: dict, seed: int, ids, device) -> torch.Tensor:
    """[len(ids), F] float32: the feature rows of node ``ids`` (the
    dummy N, and ids past it, zero)."""
    ids = torch.as_tensor(ids, device=device)
    out = torch.empty((ids.shape[0], cfg["feature_dim"]),
                      dtype=torch.float32, device=device)
    _features_into(out, cfg, seed, ids)
    return out


def adjacency_rows(cfg: dict, seed: int, ids, device,
                   cdf: torch.Tensor | None = None) -> torch.Tensor:
    """[len(ids), max_degree] int32: the neighbours of node ``ids`` (the
    dummy N points at itself, ids past it hold zeros)."""
    ids = torch.as_tensor(ids, device=device)
    out = torch.empty((ids.shape[0], cfg["max_degree"]), dtype=torch.int32,
                      device=device)
    _adjacency_into(out, cfg, seed, ids,
                    zipf_cdf(cfg, device) if cdf is None else cdf)
    return out


def label_rows(cfg: dict, seed: int, ids, device) -> torch.Tensor:
    """[len(ids)] int32 class ids of node ``ids`` (-1 from the dummy N
    on)."""
    ids = torch.as_tensor(ids, device=device)
    h = _hash(seed, ids, 1, LABEL)[:, 0]
    labels = h.mul_(cfg["num_classes"]).bitwise_right_shift_(32).to(
        torch.int32)
    labels[ids >= cfg["num_nodes"]] = -1
    return labels


@dataclasses.dataclass
class Shard:
    """Shard ``index`` of ``shards`` in the port's device layout."""
    num_nodes: int
    index: int
    shards: int
    layout: str
    features: torch.Tensor      # [ss, F] float32
    adj: torch.Tensor           # [ss, max_degree] int32
    labels: torch.Tensor        # [N + 1] int32 class ids, the dummy's -1


def make_shard(cfg: dict, seed: int, index: int, device) -> Shard:
    """Shard ``index`` of the configuration's ``graph_shards``, made on
    ``device`` in chunks of ``CHUNK`` elements."""
    ids = shard_ids(cfg, index, device)
    features = torch.empty((ids.shape[0], cfg["feature_dim"]),
                           dtype=torch.float32, device=device)
    _features_into(features, cfg, seed, ids)
    adj = torch.empty((ids.shape[0], cfg["max_degree"]), dtype=torch.int32,
                      device=device)
    _adjacency_into(adj, cfg, seed, ids, zipf_cdf(cfg, device))
    n = cfg["num_nodes"]
    labels = torch.empty(n + 1, dtype=torch.int32, device=device)
    every = torch.arange(n + 1, dtype=torch.int64, device=device)
    for a, part in _chunks(every, 1):
        labels[a:a + part.shape[0]] = label_rows(cfg, seed, part, device)
    return Shard(n, index, shards(cfg), cfg.get("shard_layout", "strided"),
                 features, adj, labels)
