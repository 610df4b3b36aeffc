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

# Written as ``sitecustomize.py`` into a directory on ``PYTHONPATH``:
# every process started with it, a cell's rank processes among them,
# appends each path it opens to the file that PORT_BENCH_OPENED names.
AUDIT = r"""
import os, sys
_fd = os.open(os.environ["PORT_BENCH_OPENED"],
              os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)


def _opened(ev, args):
    if ev == "open" and args and isinstance(args[0], (str, bytes)):
        os.write(_fd, os.fsencode(os.fsdecode(args[0]) + "\n"))


sys.addaudithook(_opened)
"""

# In a fresh process, audited so: import every module of the harness
# and every metric reader, run each cell at its toy size (a cell over
# several cards over as many gloo ranks, in a checkout under
# PORT_BENCH_CHECKOUTS, each rank checking its own modules), and report
# the modules loaded.
PROBE = r"""
import importlib, json, os, pkgutil, sys
from pathlib import Path
import port_bench
from port_bench import harness, ranks, spec
for m in pkgutil.walk_packages(port_bench.__path__, "port_bench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
from port_bench.tests.conftest import cell_checkout, toy
for w in bench["workloads"]:
    if w["chips"] == 1:
        harness.run_cell(toy(w["name"]), 5, 0.1, True, "cpu")
        continue
    root = Path(os.environ["PORT_BENCH_CHECKOUTS"]) / w["name"]
    root.mkdir()
    r = ranks.launch(w["name"], 5, 0.3, True, w["chips"], device="cpu",
                     root=cell_checkout(root, toy(w["name"])))
    assert r is not None, f"{w['name']}: its ranks gave no result"
print(json.dumps({"loaded": sorted(sys.modules)}))
"""


def _run(code: str, **env):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                          env=full, capture_output=True, text=True,
                          timeout=600)


def test_harness_loads_no_jax_and_reads_no_benchmarks(tmp_path):
    (tmp_path / "audit").mkdir()
    (tmp_path / "audit" / "sitecustomize.py").write_text(AUDIT)
    (tmp_path / "checkouts").mkdir()
    opened = tmp_path / "opened.txt"
    proc = _run(PROBE, PYTHONPATH=str(tmp_path / "audit"),
                PORT_BENCH_OPENED=str(opened),
                PORT_BENCH_CHECKOUTS=str(tmp_path / "checkouts"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in seen["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    assert "graphsage_tpu_torch" in seen["loaded"]
    assert not [m for m in seen["loaded"]
                if m.startswith("graphsage_tpu_torch.benchmarks")
                or m == "bench"]
    # this checkout, the cells' checkouts, and the repo the port is in
    roots = {str(spec.ROOT), str(tmp_path / "checkouts"),
             str((spec.ROOT / "graphsage_tpu_torch").resolve().parent)}
    paths = opened.read_text().splitlines()
    assert any(p.endswith("harness.py") for p in paths)
    read = [p for p in paths for q in {p, os.path.realpath(p)}
            for root in roots if q.startswith(root)
            and (q.startswith(os.path.join(root, "benchmarks"))
                 or q.endswith(os.sep + "bench.py"))]
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
