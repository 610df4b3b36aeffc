"""Supervised GraphSAGE, written plainly from the paper (Hamilton, Ying
and Leskovec, NeurIPS 2017, Algorithm 1 and section 3.3) and the
reference code's defaults (``williamleif/GraphSAGE``,
``supervised_train.py``): K layers, each a self projection and a
neighbour projection concatenated, relu except on the last layer; the
neighbours reduced by their mean (``mean``) or by the mean of a
per-neighbour relu layer (``meanpool``); the l2-normalised embedding
into a dense softmax head; each gradient element clipped to +-clip,
then Adam.

Sampling is the reference's: one permutation of the ``max_degree``
adjacency columns per hop and batch, shared by every row, of which the
first S are taken. The permutations come from ``torch.randperm`` on a
generator seeded as the run seeded the program's, drawn in the same
order (the outer hop first); ``PermStream`` replays them.

Everything is float32 under ``precision(tf32=False)``. The gathers are
plain ``index_select``; ``log_predictions`` works in blocks of nodes so
that the innermost hop's rows fit.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in full f32 (``tf32=False``) or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fanouts(cfg: dict) -> tuple:
    """Fanouts in layer order: (samples_1, samples_2)."""
    return (cfg["samples_1"], cfg["samples_2"])


def layer_dims(cfg: dict) -> tuple:
    """(input width, output width of each layer before the concat)."""
    return (cfg["feature_dim"], cfg["dim_1"], cfg["dim_2"])


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter, named as the port names them;
    a name ending in ``.b`` is a bias (zero at the start), every other a
    glorot-uniform weight."""
    dims = layer_dims(cfg)
    shapes = {}
    for layer in range(len(fanouts(cfg))):
        d_in = dims[0] if layer == 0 else 2 * dims[layer]
        d_out = dims[layer + 1]
        prefix = f"aggs.{layer}."
        if cfg["aggregator"] == "mean":
            shapes[prefix + "neigh_w"] = (d_in, d_out)
            shapes[prefix + "self_w"] = (d_in, d_out)
        elif cfg["aggregator"] == "meanpool":
            hidden = cfg["pool_hidden"]
            shapes[prefix + "mlp.0.w"] = (d_in, hidden)
            shapes[prefix + "mlp.0.b"] = (hidden,)
            shapes[prefix + "neigh_w"] = (hidden, d_out)
            shapes[prefix + "self_w"] = (d_in, d_out)
        else:
            raise ValueError(f"no reference for {cfg['aggregator']!r}")
    shapes["head.w"] = (2 * dims[-1], cfg["num_classes"])
    shapes["head.b"] = (cfg["num_classes"],)
    return shapes


def glorot_limit(shape) -> float:
    return math.sqrt(6.0 / (shape[0] + shape[1]))


class PermStream:
    """The sampler's column permutations, replayed from its seed: one
    ``randperm(max_degree)`` per hop of each batch, the outer hop's
    first."""

    def __init__(self, seed: int, max_degree: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.max_degree = max_degree
        self.device = torch.device(device)

    def take(self, n: int) -> list:
        return [torch.randperm(self.max_degree, generator=self.gen,
                               device=self.device) for _ in range(n)]

    def skip(self, n: int) -> None:
        for _ in range(n):
            torch.randperm(self.max_degree, generator=self.gen,
                           device=self.device)


def frontiers(cfg: dict, adj, ids, perms) -> list:
    """[ids, hop 1 ids, hop 2 ids, ...], flat; hop k+1 takes the first
    S columns of ``perms[k]`` from the adjacency rows of hop k."""
    fo = fanouts(cfg)
    out = [ids]
    for k, perm in enumerate(perms):
        s = fo[len(fo) - 1 - k]
        out.append(adj.index_select(0, out[-1])[:, perm[:s]].reshape(-1))
    return out


def _aggregate(cfg, params, layer, self_rows, neigh, last):
    prefix = f"aggs.{layer}."
    if cfg["aggregator"] == "mean":
        pooled = neigh.mean(dim=1)
    else:
        n, s, d = neigh.shape
        h = torch.relu(neigh.reshape(n * s, d) @ params[prefix + "mlp.0.w"]
                       + params[prefix + "mlp.0.b"])
        pooled = h.view(n, s, -1).mean(dim=1)
    out = torch.cat([self_rows @ params[prefix + "self_w"],
                     pooled @ params[prefix + "neigh_w"]], dim=1)
    return out if last else torch.relu(out)


def embed(cfg: dict, params: dict, features, adj, ids, perms):
    """[B, 2 * dim_2] raw embeddings of ``ids`` from the hops' rows."""
    fo = fanouts(cfg)
    n_layers = len(fo)
    hidden = [features.index_select(0, f)
              for f in frontiers(cfg, adj, ids, perms)]
    for layer in range(n_layers):
        nxt = []
        for hop in range(n_layers - layer):
            s = fo[n_layers - 1 - hop]
            neigh = hidden[hop + 1].view(hidden[hop].shape[0], s, -1)
            nxt.append(_aggregate(cfg, params, layer, hidden[hop], neigh,
                                  layer == n_layers - 1))
        hidden = nxt
    return hidden[0]


def logits(cfg: dict, params: dict, features, adj, ids, perms):
    e = embed(cfg, params, features, adj, ids, perms)
    e = e / torch.sqrt(torch.clamp((e * e).sum(dim=1, keepdim=True),
                                   min=1e-12))
    return e @ params["head.w"] + params["head.b"]


def log_predictions(cfg, params, features, adj, ids, perms,
                    block: int = 2048):
    """[B, C] log softmax of the logits, ``block`` nodes at a time."""
    with torch.no_grad():
        return torch.cat([
            torch.log_softmax(logits(cfg, params, features, adj,
                                     ids[i:i + block], perms), dim=-1)
            for i in range(0, ids.shape[0], block)])


def loss(cfg, params, features, adj, ids, labels_table, perms,
         num_nodes: int):
    """Softmax cross-entropy averaged over the real ids (``ids !=
    num_nodes``; the dummy id pads a batch)."""
    lg = logits(cfg, params, features, adj, ids, perms)
    labels = labels_table.index_select(0, ids)
    per_node = -(labels * torch.log_softmax(lg, dim=-1)).sum(dim=-1)
    mask = (ids != num_nodes).float()
    return (per_node * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class Adam:
    """Each gradient element clipped to +-clip, then Adam (b1 0.9, b2
    0.999, eps 1e-8 added to the bias-corrected sqrt(v))."""

    def __init__(self, params: dict, lr: float, clip: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k].clamp(-self.clip, self.clip)
                self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
                p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def loss_and_grads(cfg, params, features, adj, ids, labels_table, perms,
                   num_nodes: int):
    """(loss, {name: gradient}) of one batch at ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    value = loss(cfg, leaves, features, adj, ids, labels_table, perms,
                 num_nodes)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), dict(zip(leaves, grads))

