"""On the card (marked ``cuda``; skipped without one): each cell runs at
its own size and is correct, and its control, the reference in TF32 put
in the port's place, is refused by the check.

    python -m pytest port_bench/tests -q -m cuda
"""

from __future__ import annotations

import pytest

from port_bench import calibrate, harness, program, spec
from port_bench.tests.conftest import CELLS

SEED = 3_100_000_001


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    cell = spec.cell(name)
    cell.traffic["trace_after_s"] = 0.2   # both spans inside 2 s
    program.build_kernels(cell.config)
    r = harness.run_cell(cell, SEED, 2.0, True, card)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused_on_the_card(card, name):
    out = calibrate.readings(spec.cell(name), [], [SEED], [], 1.0, card)
    assert out[0]["correct"] is False, out[0]["numbers"]
