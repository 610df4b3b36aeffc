"""Torch checkpoints: ``<root>/step_<step>.pt`` holds a ``torch.save``d
dict ``{"params": {key path: tensor}, "step": int}``, keyed by the weight
bridge's paths (``params.py``). A model trained by the JAX package
reaches the port through ``params_from_jax``; the port does not read
the JAX package's Orbax checkpoints.
"""

from __future__ import annotations

import os

import torch


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step:010d}.pt")


def save(root: str, params: dict, step: int) -> str:
    """Write atomically (temporary name, then rename); returns the path."""
    os.makedirs(os.path.abspath(root), exist_ok=True)
    path = _ckpt_path(root, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                "step": int(step)}, tmp)
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


def restore(root: str, device="cpu"):
    """-> (params, step) from the newest checkpoint, or None."""
    step = latest_step(root)
    if step is None:
        return None
    state = torch.load(_ckpt_path(root, step), map_location=device,
                       weights_only=True)
    return state["params"], int(state["step"])
