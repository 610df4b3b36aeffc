"""Dense layer: dropout -> matmul -> +bias -> activation, with
glorot-uniform weights and a zero bias.

A bf16 input is dropped out in bf16 and promoted to the weight's f32
for the product, as ``jnp.dot(x, w, preferred_element_type=f32)``
promotes it in the JAX package.

``shard`` (a ``parallel/tensor.py::ModelShard``): ``x`` is a rank's
block of the raw input's columns and ``w`` the matching rows, under
tensor parallelism; the block's mask is the whole row's, and the
partial product is summed over the model group before the bias."""

from __future__ import annotations

import torch

from graphsage_tpu_torch.nn.init import dropout, glorot, zeros


def init_dense(generator: torch.Generator, input_dim: int, output_dim: int,
               bias: bool = True, device="cpu") -> dict:
    params = {"w": glorot(generator, (input_dim, output_dim), device)}
    if bias:
        params["b"] = zeros((output_dim,), device)
    return params


def apply_dense(
    params: dict,
    x: torch.Tensor,
    *,
    act=None,
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
    shard=None,
) -> torch.Tensor:
    drop = dropout if shard is None else shard.dropout
    x = drop(generator, x, dropout_rate, deterministic)
    out = x.to(params["w"].dtype) @ params["w"]
    if shard is not None:
        out = shard.reduce(out)
    if "b" in params:
        out = out + params["b"]
    if act is not None:
        out = act(out)
    return out
