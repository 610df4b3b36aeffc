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

Under tensor parallelism (``--n_model_shards``, ``parallel/tensor.py``)
a rank holds a shard of some parameters: ``params_to_model_shard``
cuts the logical (whole) params, the JAX package's ``jax.device_get``
of its GSPMD-placed tree, into rank m's shard, and
``params_from_model_shards`` puts the ranks' shards back together. The
same two serve Adam's moments, keyed as the params.
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


def params_to_model_shard(flat: dict, sage_config, n_model: int,
                          index: int) -> dict:
    """Rank ``index``'s shard of whole params ``flat`` (tensors or NumPy
    arrays) under ``n_model``-way tensor parallelism; the parameters
    that are not split are passed as they are."""
    from graphsage_tpu_torch.parallel.tensor import shard_index, split_params

    out = dict(flat)
    for k, (dim, kind) in split_params(sage_config).items():
        if k not in flat:
            continue
        v = flat[k]
        idx = shard_index(sage_config, kind, v.shape[dim], n_model, index)
        if isinstance(v, torch.Tensor):
            out[k] = v.index_select(dim, torch.from_numpy(idx).to(v.device))
        else:
            out[k] = np.take(v, idx, axis=dim)
    return out


def params_from_model_shards(shards: list, sage_config) -> dict:
    """The whole params from every rank's shard (tensors), in model-rank
    order: the inverse of ``params_to_model_shard``."""
    from graphsage_tpu_torch.parallel.tensor import (
        input_rows,
        shard_index,
        split_params,
    )

    n = len(shards)
    out = dict(shards[0])
    for k, (dim, kind) in split_params(sage_config).items():
        if k not in out:
            continue
        parts = [s[k] for s in shards]
        if kind == "lstm":   # the recurrent rows follow the input rows
            whole_len = (sage_config.input_dim + parts[0].shape[0]
                         - len(input_rows(sage_config, n, 0)))
        else:
            whole_len = sum(p.shape[dim] for p in parts)
        shape = list(parts[0].shape)
        shape[dim] = whole_len
        whole = parts[0].new_empty(shape)
        for m, part in enumerate(parts):
            idx = shard_index(sage_config, kind, whole_len, n, m)
            whole.index_copy_(dim, torch.from_numpy(idx).to(part.device),
                              part)
        out[k] = whole
    return out
