"""Torch checkpoints: ``<root>/step_<step>.pt`` holds a ``torch.save``d
dict ``{"params": {key path: tensor}, "step": int}`` and, from a
training run, ``"opt_state": {"count": int, "mu": {...}, "nu": {...}}``
(Adam's moments keyed like the params, see
``models/supervised.py::ClippedAdam.state_dict``). Keys follow the
weight bridge's paths (``params.py``). A model trained by the JAX
package reaches the port through ``params_from_jax`` and
``opt_state_from_jax``; the port does not read the JAX package's Orbax
checkpoints.
"""

from __future__ import annotations

import os

import torch


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:010d}.pt")


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save(root: str, params: dict, step: int,
         opt_state: dict | None = None) -> str:
    """Write atomically (temporary name, then rename); returns the path."""
    os.makedirs(os.path.abspath(root), exist_ok=True)
    path = _ckpt_path(root, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    state = {"params": _cpu(params), "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = {"count": int(opt_state["count"]),
                              "mu": _cpu(opt_state["mu"]),
                              "nu": _cpu(opt_state["nu"])}
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(root: str) -> int | None:
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return None
    steps = [
        int(f[len("step_"):-len(".pt")])
        for f in os.listdir(root)
        if f.startswith("step_") and f.endswith(".pt")
    ]
    return max(steps) if steps else None


def restore_train_state(root: str, device="cpu"):
    """-> (params, opt_state or None, step) from the newest checkpoint,
    or None. A checkpoint written without optimizer state (by
    ``predict``'s callers, or an older version of the port) gives
    ``opt_state`` None."""
    step = latest_step(root)
    if step is None:
        return None
    state = torch.load(_ckpt_path(root, step), map_location=device,
                       weights_only=True)
    return state["params"], state.get("opt_state"), int(state["step"])


def check_matches(params: dict, expected: dict) -> None:
    """Raise unless ``params`` has ``expected``'s keys and shapes."""
    got = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(v.shape) for k, v in expected.items()}
    if got != want:
        raise ValueError(
            "checkpoint does not match the model: "
            f"stored {got}, expected {want}"
        )


def restore(root: str, device="cpu"):
    """-> (params, step) from the newest checkpoint, or None."""
    restored = restore_train_state(root, device)
    if restored is None:
        return None
    params, _, step = restored
    return params, step
