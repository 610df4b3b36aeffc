"""The weight bridge between the JAX package's parameter pytree and the
port's flat dict of tensors.

A JAX pytree such as ``{"aggs": [{"neigh_w": ..., "self_w": ...}, ...],
"head": {"w": ..., "b": ...}, "embeds": ...}`` maps to keys
``aggs.0.neigh_w``, ``head.w``, ``embeds``: list positions become path
components. The bridge sees NumPy arrays only (the caller hands over
``jax.device_get(params)``), so the port never touches a JAX array.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu") -> dict[str, torch.Tensor]:
    """Nested dicts/lists of arrays -> {dotted key path: tensor}."""
    flat: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            arr = np.array(node, copy=True)
            flat[".".join(path)] = torch.from_numpy(arr).to(device)

    walk(tree, ())
    return flat


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """{dotted key path: tensor} -> the JAX pytree of NumPy arrays, with
    dicts keyed 0..n-1 turned back into lists."""
    tree: dict = {}
    for key, value in params.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy()
    return _to_lists(tree)


def _to_lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _to_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node
