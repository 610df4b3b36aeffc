"""Fixtures of the benchmark's tests: the cells at a toy size on the CPU
(the port then takes its kernels' plain versions), and the cards, for
the tests marked ``cuda``, which skip where there are fewer than a test
needs.

A cell's toy size is ``TOY_CONFIG`` over its configuration (which keeps
its ``graph_shards``) and its mode's ``TOY`` over its traffic. A cell on
one card runs in the test's process; a cell over several runs through
``ranks.launch`` in a checkout written with its files cut
(``cell_checkout``), since each rank reads the cell from its files.

Run them with ``python -m pytest port_bench/tests -q``; the card's with
``python -m pytest port_bench/tests -q -m cuda`` on a machine with one.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from port_bench import spec

TOY_CONFIG = dict(num_nodes=300, feature_dim=12, num_classes=5,
                  samples_1=5, samples_2=3, dim_1=8, dim_2=8,
                  max_degree=16, pool_hidden=16)
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
PORT = "graphsage_tpu_torch"


def toy(name: str, root=spec.ROOT) -> spec.Cell:
    """Cell ``name`` with its configuration and traffic cut to a toy
    size, its limits as committed."""
    cell = spec.cell(name, root=root)
    cell.config.update(TOY_CONFIG)
    cell.traffic.update(spec.mode(cell.traffic["mode"]).TOY)
    cell.traffic["trace_after_s"] = 0.05
    return cell


def harness_checkout(root: Path, tests: bool = False) -> Path:
    """A checkout at ``root``: ``BENCHMARK.json`` and the harness as they
    are here, the port linked; with ``tests``, the harness's tests and
    the pytest settings too."""
    shutil.copytree(spec.HERE, root / spec.HERE.name,
                    ignore=shutil.ignore_patterns(
                        "__pycache__", *(() if tests else ("tests",))))
    if tests:
        shutil.copy(spec.ROOT / "pyproject.toml", root / "pyproject.toml")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / PORT).symlink_to(spec.ROOT / PORT)
    return root


def cell_checkout(root: Path, cell: spec.Cell) -> Path:
    """``harness_checkout(root)`` with ``cell``'s configuration and
    traffic files written as ``cell`` holds them."""
    harness_checkout(root)
    bench = spec.benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == cell.name)
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    (root / config["file"]).write_text(json.dumps(cell.config))
    (root / spec.HERE.name / "traffic" / f"{w['traffic']}.json").write_text(
        json.dumps(cell.traffic))
    return root


def cards(n: int) -> list:
    """The first ``n`` CUDA devices; the test skips with fewer."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        pytest.skip(f"needs {n} CUDA device(s), found {found} (runs on the "
                    "card)")
    return [torch.device("cuda", i) for i in range(n)]
