"""What the harness may not touch: JAX and the JAX package (compared by
whole top-level names, so ``graphsage_tpu_torch`` is no match), the
port's own drivers and the files of ``benchmarks/``; the reference takes
nothing of the port; and the command refuses a machine with no card."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from port_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "graphsage_tpu")

# In a fresh process: import every module of the harness and every
# metric reader, run one toy cell of each mode with an audit hook that
# records every file opened, and report the modules loaded.
PROBE = r"""
import importlib, json, pkgutil, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str)
                 else None)
import port_bench
from port_bench import harness, spec
for m in pkgutil.walk_packages(port_bench.__path__, "port_bench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
from port_bench.tests.conftest import toy
for w in bench["workloads"]:
    harness.run_cell(toy(w["name"]), 5, 0.1, True, "cpu")
print(json.dumps({"loaded": sorted(sys.modules), "opened": opened}))
"""


def _run(code: str, **env):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          env=full, capture_output=True, text=True,
                          timeout=600)


def test_harness_loads_no_jax_and_reads_no_benchmarks():
    proc = _run(PROBE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in seen["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    assert "graphsage_tpu_torch" in seen["loaded"]
    assert not [m for m in seen["loaded"]
                if m.startswith("graphsage_tpu_torch.benchmarks")
                or m == "bench"]
    root = str(spec.ROOT)
    read = [p for p in seen["opened"] if p.startswith(root)
            and (p.startswith(os.path.join(root, "benchmarks"))
                 or p.endswith(os.sep + "bench.py"))]
    assert read == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_harness_imports_jax_or_the_drivers():
    for path in spec.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert not name.startswith("graphsage_tpu_torch.benchmarks"), (
                path, name)
            assert name.split(".")[0] not in ("bench", "benchmarks",
                                              "chip_smoke"), (path, name)


def test_reference_imports_nothing_of_the_port():
    for path in (spec.HERE / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN + (
                "graphsage_tpu_torch",), (path, name)
    proc = _run("import json, sys, port_bench.reference.sage; "
                "print(json.dumps(sorted(sys.modules)))")
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN + (
        "graphsage_tpu_torch",)]


def test_command_refuses_a_machine_without_a_card():
    cell = spec.benchmark()["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", cell,
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "CUDA" in proc.stderr
