"""On the card (marked ``cuda``; skipped with fewer cards than a cell
asks for): each cell runs at its own size and is correct, and its
control, the reference in TF32 put in the port's place, is refused by
the check. A cell on one card runs in the test's process; a cell on
several through the command (``python3 -m port_bench.run``) and, for its
control, ``ranks.launch``, each rank on its own card.

    python -m pytest port_bench/tests -q -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench import calibrate, harness, program, spec
from port_bench.tests.conftest import CELLS, cards, cell_checkout

SEED = 3_100_000_001


def _command(root, name: str, seed: int, seconds: float, trace: int):
    """The command's result in the checkout at ``root``."""
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", str(seed), "--seconds", repr(seconds), "--trace",
         str(trace)], cwd=root, capture_output=True, text=True,
        timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(name, tmp_path):
    cell = spec.cell(name)
    held = cards(cell.chips)
    cell.traffic["trace_after_s"] = 0.2   # both spans inside 2 s
    if cell.chips == 1:
        program.build_kernels(cell.config)
        r = harness.run_cell(cell, SEED, 2.0, True, held[0])
    else:
        r = _command(cell_checkout(tmp_path, cell), name, SEED, 2.0, 1)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["count"] == cell.chips
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused_on_the_card(name):
    cell = spec.cell(name)
    held = cards(cell.chips)
    out = calibrate.readings(cell, [], [SEED], [], 1.0, held[0])
    assert out[0]["numbers"], "the control's run gave no result"
    assert out[0]["correct"] is False, out[0]["numbers"]
