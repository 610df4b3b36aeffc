"""Shared helpers of the PyTorch port's parity tests.

Inputs are made with NumPy from a seed and handed to both packages; the
JAX side runs on the CPU as the rest of the suite does.
"""

import jax
import numpy as np
import torch

# six xdist workers share the machine
torch.set_num_threads(2)


def t(x) -> torch.Tensor:
    """NumPy (or a JAX array) -> CPU tensor."""
    return torch.from_numpy(np.array(x, copy=True))


def port_params(jax_params) -> dict:
    """JAX pytree -> the port's flat dict, through the weight bridge."""
    from graphsage_tpu_torch.params import params_from_jax

    return params_from_jax(jax.device_get(jax_params))
