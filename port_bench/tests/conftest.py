"""Fixtures of the benchmark's tests: the cells at a toy size on the CPU
(the port then takes its kernels' plain versions), and the card, for
the tests marked ``cuda``, which skip where there is none.

Run them with ``python -m pytest port_bench/tests -q``; the card's with
``python -m pytest port_bench/tests -q -m cuda`` on a machine with one.
"""

from __future__ import annotations

import pytest
import torch

from port_bench import spec

TOY_CONFIG = dict(num_nodes=300, feature_dim=12, num_classes=5,
                  samples_1=5, samples_2=3, dim_1=8, dim_2=8,
                  max_degree=16, pool_hidden=16)
TOY_TRAFFIC = {
    "train": dict(batch_size=32),
    "sweep": dict(batch_size=64),
    "requests": dict(batch_size=16, rate_per_s=100, warmup_requests=3,
                     checked_requests=5, trace_requests=10),
}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def toy(name: str, root=spec.ROOT) -> spec.Cell:
    """Cell ``name`` with its configuration and traffic cut to a toy
    size, its limits as committed."""
    cell = spec.cell(name, root=root)
    cell.config.update(TOY_CONFIG)
    cell.traffic.update(TOY_TRAFFIC[cell.traffic["mode"]])
    cell.traffic["trace_after_s"] = 0.05
    return cell


@pytest.fixture
def card():
    """The first CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda", 0)
