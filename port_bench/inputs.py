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
