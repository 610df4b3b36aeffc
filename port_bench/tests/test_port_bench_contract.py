"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, the files each entry names, and what each cell
reports."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import spec

BENCH = spec.benchmark()
WHY = re.compile(r"^[^\t\n]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(WHY.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (spec.ROOT / p).is_dir()


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_names_and_keys(section):
    entries = BENCH[section]
    assert 1 <= len(entries)
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        keys = set(e)
        assert ENTRY_KEYS[section] <= keys <= ENTRY_KEYS[section] | {
            "workloads"}, e
        assert spec.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]) and e["better"] in (
                "lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert WHY.match(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


def test_configurations():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(spec.NAME.match(k) for k in c["reduced"])


def test_cells_and_their_files():
    wl = BENCH["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in wl]
    assert len(set(pairs)) == len(pairs) and len(wl) <= 24
    assert sum(w["chips"] == 4 for w in wl) <= max(1, len(wl) // 4)
    for w in wl:
        assert w["chips"] in (1, 4)
        assert spec.NAME.match(w["traffic"]) and spec.NAME.match(w["config"])
        cell = spec.cell(w["name"])
        spec.mode(cell.traffic["mode"])
        assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_each_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or cell in reports
        assert any((spec.HERE / "metrics" / f"{stem}.py").is_file()
                   for stem in (m["name"], spec.family(m["name"])))
        assert callable(spec.reader(m["name"]))
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
