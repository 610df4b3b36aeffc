"""Counts from shapes: edges a step, model FLOPs, and the bytes and
operations of the innermost hop's kernels; the card's peaks.

Peaks: NVIDIA's H100 SXM data sheet, dense rates. The operation peak
for the kernels' rooflines and for ``mfu`` is the TF32 tensor-core rate:
no implementation that keeps the configuration's float32 accuracy
(3xTF32, 2xTF32 or SIMT f32) can read above it.

The kernels' byte counts are those of the port's ``chip_smoke.py``
(``gather_bytes_ms``, ``pool_bounds``), copied here: each distinct
gathered row read once, the ids, the weights and the output once, K6's
residual written once. Their operation count is the hop's product,
2 * rows * F * H.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 80 GB HBM3
TF32_FLOPS_PER_S = 495e12      # H100 SXM, TF32 tensor cores, dense


def supports(fanouts: tuple) -> list:
    """Rows of each frontier a batch row expands to: [1, S_K, S_K *
    S_{K-1}, ...] for fanouts in layer order."""
    out = [1]
    for s in reversed(fanouts):
        out.append(out[-1] * s)
    return out


def edges_per_batch(fanouts: tuple, batch: int) -> int:
    """Sampled edges a batch aggregates: batch * (S_K + S_K * S_{K-1} +
    ...), 133,120 at 512 x (10 + 10 * 25) (the JAX ``bench.py:378``)."""
    return batch * sum(supports(fanouts)[1:])


def _products(cfg: dict, batch: int):
    """(m, k, n, input needs a gradient) of every product of a batch's
    forward, and (elements, input needs a gradient) of every mean."""
    fo = (cfg["samples_1"], cfg["samples_2"])
    dims = (cfg["feature_dim"], cfg["dim_1"], cfg["dim_2"])
    sup = supports(fo)
    n_layers = len(fo)
    products, means = [], []
    for layer in range(n_layers):
        d_in = dims[0] if layer == 0 else 2 * dims[layer]
        d_out = dims[layer + 1]
        grad_in = layer > 0
        for hop in range(n_layers - layer):
            rows = batch * sup[hop]
            s = fo[n_layers - 1 - hop]
            products.append((rows, d_in, d_out, grad_in))       # self
            if cfg["aggregator"] == "mean":
                means.append((rows * s * d_in, grad_in))
                products.append((rows, d_in, d_out, grad_in))   # neigh
            elif cfg["aggregator"] in ("meanpool", "maxpool"):
                hidden = cfg["pool_hidden"]
                products.append((rows * s, d_in, hidden, grad_in))
                means.append((rows * s * hidden, True))
                products.append((rows, hidden, d_out, True))
            else:
                raise ValueError(f"no count for {cfg['aggregator']!r}")
    products.append((batch, 2 * dims[-1], cfg["num_classes"], True))
    return products, means


def model_flops(cfg: dict, batch: int, training: bool) -> float:
    """FLOPs of one batch: the forward's products (2mkn) and means (one
    a summed element); training adds each product's weight gradient and
    the gradients of the activations that lead to a weight (the feature
    table takes none)."""
    products, means = _products(cfg, batch)
    flops = sum(2.0 * m * k * n for m, k, n, _ in products)
    flops += sum(float(e) for e, _ in means)
    if training:
        flops += sum(2.0 * m * k * n * (1 + g) for m, k, n, g in products)
        flops += sum(float(e) for e, g in means if g)
    return flops


def distinct(idx: torch.Tensor) -> int:
    return int(torch.unique(idx).numel())


def gather_mean_bytes(idx: torch.Tensor, feature_dim: int,
                      elem: int = 4) -> int:
    """K1: the distinct rows of ``idx`` [B, S], the [B, F] f32 output,
    the ids."""
    return (distinct(idx) * feature_dim * elem
            + idx.shape[0] * feature_dim * 4 + idx.numel() * 4)


def gather_pool_bytes(idx: torch.Tensor, feature_dim: int, hidden: int,
                      residual: bool, elem: int = 4) -> int:
    """K5 (``residual`` False) and K6: the distinct rows, w and b, the
    ids, the [B, H] output, and K6's [B*S, F] f32 residual."""
    b, s = idx.shape
    return (distinct(idx) * feature_dim * elem + feature_dim * hidden * 4
            + hidden * 4 + idx.numel() * 4 + b * hidden * 4
            + (b * s * feature_dim * 4 if residual else 0))


def gather_pool_flops(idx: torch.Tensor, feature_dim: int,
                      hidden: int) -> float:
    return 2.0 * idx.numel() * feature_dim * hidden


def least_seconds(n_bytes: float, flops: float = 0.0) -> float:
    """The roofline's least time: the larger of bytes at the memory rate
    and operations at the TF32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S)
