"""The weight bridge between the JAX package's parameter pytree and the
port's flat dict of tensors.

A JAX pytree such as ``{"aggs": [{"neigh_w": ..., "self_w": ...}, ...],
"head": {"w": ..., "b": ...}, "embeds": ...}`` maps to keys
``aggs.0.neigh_w``, ``head.w``, ``embeds``: list positions become path
components. node2vec's ``{"target", "context", "bias"}`` keeps its three
keys. The bridge sees NumPy arrays only (the caller hands over
``jax.device_get(params)``), so the port never touches a JAX array.

The optimizer state crosses the same way. The JAX package's optimizer,
``optax.chain(optax.clip(5), optax.adam(...))``, keeps its state as
``(EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState()))``;
the bridge finds the Adam node by its fields and carries count, mu and
nu to the port's form ``{"count": int, "mu": {key: tensor}, "nu":
{key: tensor}}`` (``models/supervised.py::ClippedAdam``) and back,
without importing optax.
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


def _is_adam_state(node) -> bool:
    return all(hasattr(node, f) for f in ("count", "mu", "nu"))


def _find_adam_state(node):
    if _is_adam_state(node):
        return node
    if isinstance(node, (list, tuple)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, device="cpu") -> dict:
    """optax chain(clip, adam) state (NumPy leaves) -> {"count", "mu",
    "nu"} of the port."""
    adam = _find_adam_state(state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    return {"count": int(np.asarray(adam.count)),
            "mu": params_from_jax(adam.mu, device),
            "nu": params_from_jax(adam.nu, device)}


def opt_state_to_jax(state: dict, like):
    """The port's {"count", "mu", "nu"} -> the structure of ``like`` (an
    optax state of NumPy leaves, e.g. ``jax.device_get(opt.init(p))``)
    with its Adam node's count, mu and nu replaced."""

    def rebuild(node):
        if _is_adam_state(node):
            return node._replace(
                count=np.asarray(state["count"],
                                 dtype=np.asarray(node.count).dtype),
                mu=params_to_jax(state["mu"]),
                nu=params_to_jax(state["nu"]),
            )
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(rebuild(child) for child in node)
        return node

    if _find_adam_state(like) is None:
        raise ValueError("no Adam state (count, mu, nu) in ``like``")
    return rebuild(like)
