"""Each cell's driver at a toy size on the CPU, its result's keys; the
faults the output check has to refuse; a cell, configuration and metric
added as files alone; the open loop's schedule. A cell on one card runs
in this process, a cell over several over as many gloo ranks, in a
checkout that holds its files cut to the toy size."""

from __future__ import annotations

import contextlib
import json
import shutil

import numpy as np
import pytest

from port_bench import calibrate, faults, harness, ranks, spec
from port_bench.modes import requests
from port_bench.tests.conftest import CELLS, TOY_CONFIG, cell_checkout, toy

SEED = 3_000_000_007   # above 2**31: seeds take more than 32 bits


def toy_run(name, root, trace=False, fault=None):
    """Cell ``name`` at its toy size on the CPU, ``fault`` planted ->
    (the toy cell, its result); over several ranks, in a checkout
    written at ``root``."""
    cell = toy(name)
    if cell.chips > 1:
        r = ranks.launch(name, SEED, 0.3, trace, cell.chips, device="cpu",
                         root=cell_checkout(root, cell), fault=fault)
        assert r is not None, f"{cell.chips} ranks gave no result"
        return cell, r
    with (contextlib.nullcontext() if fault is None
          else faults.planted(fault)):
        return cell, harness.run_cell(cell, SEED, 0.3, trace, "cpu")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_at_a_toy_size(name, trace, tmp_path):
    cell, r = toy_run(name, tmp_path, bool(trace))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert "breakdown" in r and {"busy_s", "window_s"} <= set(r["device"])
        # the CPU runs no device operation: only the counts read
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    json.dumps(r)


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in spec.mode(spec.cell(name).traffic["mode"]).FAULTS])
def test_planted_fault_is_refused(name, fault, tmp_path):
    _, r = toy_run(name, tmp_path, fault=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_runs_in_the_programs_place(name, tmp_path):
    """The control's numbers come from the same harness (over several
    ranks, from ``ranks.launch``); on the CPU there is no TF32, so only
    the card's run (``test_port_bench_card``) can show it refused."""
    cell = toy(name)
    if cell.chips > 1:
        cell = spec.cell(name, root=cell_checkout(tmp_path, cell))
    out = calibrate.readings(cell, [], [SEED], [], 0.2, "cpu")
    assert out[0]["program"] == "control" and out[0]["numbers"]


def test_schedule_is_the_seeds():
    a = requests.schedule(300.0, 40.0, SEED)
    assert np.array_equal(a, requests.schedule(300.0, 40.0, SEED))
    b = requests.schedule(300.0, 40.0, SEED + 1)
    assert not np.array_equal(a, b)
    assert len(a) == 12000 and 0.0 <= a[0] and a[-1] <= 40.0
    gaps = np.diff(a)
    assert (gaps >= 0).all()
    # Poisson: exponential gaps (coefficient of variation 1), and counts
    # in 0.1 s bins as dispersed as their mean (not smoothed)
    assert 0.95 < gaps.std() / gaps.mean() < 1.05
    counts = np.histogram(a, bins=400, range=(0.0, 40.0))[0]
    assert 0.8 < counts.var() / counts.mean() < 1.2


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric,
    each a new file, and new entries in BENCHMARK.json: found and run
    with no edit to an existing file."""
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tmp_path / spec.HERE.name
    bench = spec.benchmark()
    cfg = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    cfg.update(TOY_CONFIG, name="toy-mean", samples_1=4, dim_1=16)
    (base / "configs" / "toy-mean.json").write_text(json.dumps(cfg))
    (base / "traffic" / "toy-train.json").write_text(json.dumps(
        {"mode": "train", "batch_size": 16, "chunk_steps": 2,
         "checked_steps": 2, "trace_after_s": 0.0, "trace_chunks": 2}))
    (base / "workloads" / "toy-cell.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-5}}))
    (base / "metrics" / "steps_traced.toy.py").write_text(
        "def read(view):\n    return float(view.units)\n")
    bench["configs"].append({"name": "toy-mean", "source": "https://x.org",
                             "file": "port_bench/configs/toy-mean.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-mean",
                               "traffic": "toy-train", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("toy-cell")
    bench["per_layer"].append({
        "name": "steps_traced.toy", "unit": "count", "better": "higher",
        "source": "device_trace", "layer": "chunk runner",
        "moves": bench["end_to_end"][0]["name"], "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("toy-cell", root=tmp_path)
    assert cell.base == base and cell.config["dim_1"] == 16
    r = harness.run_cell(cell, SEED, 0.3, True, "cpu")
    assert r["correct"] is True
    assert r["metrics"]["steps_traced.toy"]["value"] >= 2
