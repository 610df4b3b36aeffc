"""Cells over several ranks, on the CPU over gloo: a two-rank cell added
as files alone (configuration, traffic, mode, limits, reader) runs to
one result; a rank that raises, is killed, hangs or loads JAX ends the
run with no result inside a stated limit and leaves no process; the
command runs a one-card cell in its own process, and hands a cell on
several cards to the ranks."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from xml.etree import ElementTree

import pytest
import torch
import torch.distributed as dist

from port_bench import harness, ranks, run, spec
from port_bench.tests.conftest import TOY_CONFIG, harness_checkout

SEED = 3_000_000_007
LIMIT_S = 120.0      # a failed two-rank run ends inside this
CELL = "toy-ranks"


def checkout(root: Path, traffic: dict, config: dict | None = None,
             chips: int = 2, limit: float = 0, tests: bool = False) -> Path:
    """A checkout at ``root``: the harness, the port (linked), and cell
    ``CELL`` over ``chips`` ranks added as files alone, the test's mode
    among them, each compared number's limit ``limit``; with ``tests``,
    the harness's tests and the pytest settings too."""
    base = harness_checkout(root, tests) / spec.HERE.name
    shutil.copy(spec.HERE / "tests" / "rank_probe_mode.py",
                base / "modes" / "rank_probe.py")
    bench = spec.benchmark()
    cfg = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    cfg.update(config or dict(TOY_CONFIG, graph_shards=chips,
                              shard_layout="strided"), name="toy-sharded")
    (base / "configs" / "toy-sharded.json").write_text(json.dumps(cfg))
    (base / "traffic" / "toy-probe.json").write_text(json.dumps(
        {"mode": "rank_probe", **traffic}))
    (base / "workloads" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {k: limit for k, on in (("rows_differ", "probe_rows"),
                                        ("sum_gap", "whole_sum"))
                    if on in traffic}}))
    (base / "metrics" / "ranks_traced.toy.py").write_text(
        "def read(view):\n    return float(len(view.ranks))\n")
    bench["configs"].append({"name": "toy-sharded", "source": "https://x.org",
                             "file": "port_bench/configs/toy-sharded.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "toy-sharded",
                               "traffic": "toy-probe", "chips": chips,
                               "why": "a test"})
    bench["end_to_end"].append({
        "name": "rounds_per_s", "unit": "rounds/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [CELL]})
    bench["per_layer"].append({
        "name": "ranks_traced.toy", "unit": "count", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "rounds_per_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def rank_processes(parent: int | None = None) -> list:
    """The live rank processes that ``parent`` (this process) started;
    with ``parent`` 0, any process's."""
    parent = os.getpid() if parent is None else parent
    mine = f"--parent\0{parent}\0".encode() if parent else b""
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fp:
                line = fp.read()
        except OSError:
            continue
        if b"port_bench.ranks" in line and mine in line:
            found.append(int(pid))
    return found


def peaks(err: str) -> dict:
    return {int(r): int(b) for r, b in re.findall(
        r"\[rank (\d+)\] memory peak (\d+) bytes", err)}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_two_rank_cell_added_as_files_runs(tmp_path, capsys, trace):
    root = checkout(tmp_path, dict(probe_rows=200, whole_sum=True,
                                   ballast_mb=256, trace_after_s=0.0,
                                   trace_rounds=5))
    r = ranks.launch(CELL, SEED, 0.5, bool(trace), 2, device="cpu",
                     root=root)
    err = capsys.readouterr().err
    assert r is not None, err[-3000:]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] == {"rows_differ": {"value": 0, "limit": 0},
                           "sum_gap": {"value": 0, "limit": 0}}
    assert r["device"]["count"] == 2
    held = peaks(err)
    assert set(held) == {0, 1} and held[1] > held[0]   # the ballast
    assert r["device"]["memory_peak_bytes"] == held[1]
    assert "[rank 1] joined 2 ranks" in err
    if trace:
        assert r["metrics"] == {"ranks_traced.toy": {"value": 2.0,
                                                     "unit": "count"}}
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == {"rounds_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    assert rank_processes() == []


@pytest.mark.parametrize("how", ["raise", "kill", "hang", "jax"])
def test_a_failed_rank_ends_the_run_with_no_result(tmp_path, capsys, how):
    root = checkout(tmp_path, dict(whole_sum=True,
                                   fail={"rank": 1, "how": how}))
    t0 = time.perf_counter()
    r = ranks.launch(CELL, SEED, 0.5, False, 2, device="cpu", root=root,
                     after_window_s=10.0)
    took = time.perf_counter() - t0
    err = capsys.readouterr().err
    assert r is None and took < LIMIT_S
    assert "every rank killed, no result" in err
    assert rank_processes() == []
    if how == "jax":
        assert "rank 1 exited with 3" in err


def test_a_fault_planted_on_every_rank_is_refused(tmp_path, capsys):
    """The launch plants a fault and runs a program on every rank, for a
    cell's calibration; the probe's check refuses the altered row."""
    root = checkout(tmp_path, dict(probe_rows=200))
    r = ranks.launch(CELL, SEED, 0.3, False, 2, device="cpu", root=root,
                     program="control",
                     fault="port_bench.modes.rank_probe:altered_row")
    err = capsys.readouterr().err
    assert r is not None, err[-3000:]
    assert r["correct"] is False
    assert r["checks"]["rows_differ"]["value"] == 1
    assert "[rank 1] program control" in err


def test_calibration_runs_a_cell_over_its_ranks(tmp_path):
    """``calibrate readings`` makes each run through ``ranks.launch``: the
    port's, the control's and each fault of the mode's ``FAULTS``,
    planted on every rank."""
    root = checkout(tmp_path, dict(probe_rows=200))
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.calibrate", "readings",
         "--workload", CELL, "--seeds", str(SEED), "--control_seeds",
         str(SEED), "--fault_seeds", str(SEED), "--seconds", "0.3",
         "--device", "cpu"], cwd=root, env=_env(), capture_output=True,
        text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [(ln["program"], ln["fault"], ln["correct"]) for ln in lines] == [
        ("port", None, True), ("control", None, True),
        ("port", "port_bench.modes.rank_probe:altered_row", False)]
    assert [ln["numbers"]["rows_differ"] for ln in lines] == [0, 0, 1]
    assert "[rank 1] program control" in proc.stderr


def test_calibration_records_no_reading_where_the_ranks_give_none(
        tmp_path):
    """A run over the ranks that gives no result (here a rank raises)
    is no reading: ``correct`` null and no numbers, not a refusal."""
    root = checkout(tmp_path, dict(whole_sum=True,
                                   fail={"rank": 1, "how": "raise"}))
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.calibrate", "readings",
         "--workload", CELL, "--control_seeds", str(SEED), "--seconds",
         "0.3", "--device", "cpu"], cwd=root, env=_env(),
        capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [(ln["program"], ln["correct"], ln["numbers"], ln["metrics"])
            for ln in lines] == [("control", None, {}, {})]
    assert "every rank killed, no result" in proc.stderr


def _env() -> dict:
    """This environment, with no ``PYTHONPATH``: a process in a checkout
    imports the checkout's harness."""
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _digests(root: Path, paths) -> dict:
    return {str(p): hashlib.sha256((root / p).read_bytes()).hexdigest()
            for p in paths}


# the harness's per-cell test modules, run in the checkout, and the
# audit of what a cell's processes load and open
PER_CELL = ["test_port_bench_runs.py", "test_port_bench_inputs.py",
            "test_port_bench_counts.py", "test_port_bench_contract.py",
            "test_port_bench_card.py", "test_port_bench_isolation.py"]


def test_a_four_rank_cell_added_as_files_passes_the_harness_tests(tmp_path):
    """A cell over four ranks added as files alone (its mode, a sharded
    configuration, traffic, limits, a reader, its entries in
    BENCHMARK.json) passes the harness's per-cell tests in the checkout,
    on four gloo ranks: its toy runs, its mode's faults refused, its
    control, its ranks' modules and opened files; the card's tests skip.
    No file of the repo is changed. The cells the repo has are left out
    of the run: their tests run in the repo."""
    root = checkout(tmp_path / "checkout", dict(
        probe_rows=1000, whole_sum=True, trace_after_s=0.0,
        trace_rounds=20), chips=4, limit=0.5, tests=True)
    had = [p.relative_to(spec.ROOT) for p in spec.HERE.rglob("*")
           if p.is_file() and "__pycache__" not in p.parts]
    had.append(Path("pyproject.toml"))
    assert _digests(root, had) == _digests(spec.ROOT, had)
    # BENCHMARK.json: every entry as it was, the cell's appended
    bench = spec.benchmark(root)
    for section, was in spec.benchmark().items():
        if section in ("configs", "workloads", "end_to_end", "per_layer"):
            assert bench[section][:len(was)] == was
        else:
            assert bench[section] == was

    xml = tmp_path / "junit.xml"
    theirs = " and ".join(f"not {w['name']}"
                          for w in spec.benchmark()["workloads"])
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--junitxml={xml}", "-k", theirs,
         *(f"port_bench/tests/{m}" for m in PER_CELL)],
        cwd=root, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=900)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-6000:]
    assert rank_processes(proc.pid) == []
    outcome = {}
    for case in ElementTree.parse(xml).iter("testcase"):
        kids = {k.tag for k in case}
        outcome[case.get("name")] = ("skipped" if "skipped" in kids else
                                     "failed" if kids & {"failure", "error"}
                                     else "passed")
    fault = "port_bench.modes.rank_probe:altered_row"
    assert "failed" not in outcome.values(), out[-3000:]
    assert outcome["test_harness_loads_no_jax_and_reads_no_benchmarks"] == (
        "passed")
    ours = {name: state for name, state in outcome.items() if CELL in name}
    assert ours == {
        f"test_cell_runs_at_a_toy_size[{CELL}-0]": "passed",
        f"test_cell_runs_at_a_toy_size[{CELL}-1]": "passed",
        f"test_planted_fault_is_refused[{CELL}-{fault}]": "passed",
        f"test_control_runs_in_the_programs_place[{CELL}]": "passed",
        f"test_inputs_are_the_seeds[{CELL}]": "passed",
        f"test_param_shapes_are_the_ports[{CELL}]": "passed",
        f"test_cell_is_correct_on_the_card[{CELL}]": "skipped",
        f"test_control_is_refused_on_the_card[{CELL}]": "skipped",
    }, out[-3000:]


def test_a_refusal_after_the_start_kills_the_ranks(tmp_path, capsys):
    root = checkout(tmp_path, dict(whole_sum=True))
    r = ranks.launch(CELL, SEED, 0.5, False, 2, device="cpu", root=root,
                     check=lambda: "no cards here")
    assert r is None and rank_processes() == []
    assert "no cards here; every rank killed" in capsys.readouterr().err


LAUNCH = ("import sys; from port_bench import ranks; "
          "sys.exit(ranks.launch(sys.argv[1], 5, 0.5, False, 2, "
          "device='cpu', root=sys.argv[2]) is None)")


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL])
def test_the_ranks_end_with_the_command(tmp_path, sig):
    """Signalled while a rank hangs, the command ends every rank: by its
    handler (SIGTERM), or each rank by the death signal (SIGKILL)."""
    root = checkout(tmp_path, dict(whole_sum=True,
                                   fail={"rank": 1, "how": "hang"}))
    parent = subprocess.Popen([sys.executable, "-c", LAUNCH, CELL,
                               str(root)], cwd=spec.ROOT,
                              stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + LIMIT_S
        while len(rank_processes(parent.pid)) < 2:
            assert time.monotonic() < deadline and parent.poll() is None
            time.sleep(0.1)
        time.sleep(3.0)
        parent.send_signal(sig)
        parent.wait(timeout=30)
        deadline = time.monotonic() + 30
        while rank_processes(parent.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert rank_processes(parent.pid) == []
        assert parent.returncode != 0
    finally:
        parent.kill()
        parent.communicate()


def _fake_card(monkeypatch, chips: int):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)
    monkeypatch.setattr(run, "smi", lambda *a, **k: "a card")


RESULT = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
          "device": {}, "checks": {"gap": {"value": 0.0, "limit": 1.0}}}


def test_one_card_runs_in_the_commands_process(monkeypatch, capsys):
    _fake_card(monkeypatch, 1)
    calls = []

    def run_cell(cell, seed, seconds, trace, device, **kw):
        calls.append((cell.chips, device, kw.get("ranks")))
        return RESULT

    def no_process(*a, **k):
        raise AssertionError("a one-card cell started a process")
    monkeypatch.setattr(harness, "run_cell", run_cell)
    monkeypatch.setattr(ranks, "launch", no_process)
    monkeypatch.setattr(subprocess, "Popen", no_process)
    cell = spec.benchmark()["workloads"][0]["name"]
    assert run.main(["--workload", cell, "--seed", "5", "--seconds", "1"]) \
        == 0
    assert calls == [(1, torch.device("cuda", 0), None)]
    assert not dist.is_initialized()
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == RESULT


@pytest.mark.parametrize("result", [RESULT, None])
def test_several_cards_go_to_the_ranks(monkeypatch, capsys, result):
    """The ranks start first; the command then looks for the cards."""
    _fake_card(monkeypatch, 2)
    monkeypatch.setattr(spec, "cell", lambda name: spec.Cell(
        name, 2, {}, {}, {}, [], []))
    calls = []

    def launch(*args, check, **kw):
        calls.append((args, kw))
        return None if check() else result
    monkeypatch.setattr(ranks, "launch", launch)
    code = run.main(["--workload", CELL, "--seed", "5", "--seconds", "1"])
    cap = capsys.readouterr()
    assert calls == [((CELL, 5, 1.0, False, 2), {"t_start": run.T_START})]
    if result is None:
        assert code == 1 and '"correct"' not in cap.out
    else:
        assert code == 0
        assert json.loads(cap.out.strip().splitlines()[-1]) == RESULT
        assert cap.err.strip().splitlines()[-1] == "check gap: 0.0 (limit 1.0)"
        assert cap.out.startswith("# card 0: a card\n# card 1: a card\n")


def test_several_cards_refused_without_them(monkeypatch, capsys):
    _fake_card(monkeypatch, 1)
    monkeypatch.setattr(spec, "cell", lambda name: spec.Cell(
        name, 2, {}, {}, {}, [], []))
    monkeypatch.setattr(ranks, "launch",
                        lambda *a, check, **k: check() and None)
    code = run.main(["--workload", CELL, "--seed", "5", "--seconds", "1"])
    cap = capsys.readouterr()
    assert code == 2 and '"correct"' not in cap.out
    assert "needs 2 CUDA devices, found 1" in cap.err
