"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the entry of ``configs`` with that name;
the traffic mix is ``traffic/<traffic>.json``, read by the driver its
``mode`` names (``modes/<mode>.py``); the limits of the cell's output
check are ``workloads/<cell>.json``. The per-layer metrics a cell
reports are the entries of ``per_layer`` whose ``workloads`` list it,
each read by ``metrics/<name>.py`` or, where a reader serves a family of
metrics, ``metrics/<family>.py``: the name up to its first ``.`` or
``_per_`` (``mfu.train`` -> ``mfu.py``, ``launches_per_step.train`` ->
``launches.py``).

A mode (``modes/<mode>.py``) is a module of six functions, each given
the run's ``harness.Context`` (``ctx``):

- ``setup(ctx) -> state`` and ``window(ctx, state, seconds) -> rec``
  run on every rank. ``rec`` carries ``attempted`` and ``failed``;
  ``window`` opens and closes ``ctx.span`` around whole units of its
  traffic.
- ``end_to_end(ctx, rec)``, ``check(ctx, rec)``, ``hop_ids(ctx, rec)``
  and ``unit_flops(ctx)`` run on rank 0 alone, after the window, with
  rank 0's ``rec``: the end-to-end metrics, the compared numbers (each
  named in ``workloads/<cell>.json``'s limits) and what the per-layer
  readers read (``trace.View``).

and two constants, which the harness's tests and ``calibrate.py`` read:

- ``TOY``: the traffic keys that cut the mode's cells to the tests' toy
  size on the CPU (over the traffic file's; the configuration's toy
  size is the tests' ``TOY_CONFIG``, which keeps its ``graph_shards``).
- ``FAULTS``: the faults its cells can have, each refused by the check:
  a name in ``faults.py``, or ``module:name``, the fault ``name`` of
  that module's ``planted(name)`` (a mode's own: ``f"{__name__}:name"``).

What a mode reads of the port over the metrics span (``ctx.span``'s
first phase: ``ctx.span.open`` and ``ctx.span.phase == 0``), the port's
counters (``graphsage_tpu_torch.trace.snapshot()``) or its drained
spans, it puts in ``rec``: a reader sees ``rec`` as
``view.info["record"]`` (``metrics/request_p95_ms.py`` reads the
requests' latencies so). A later cell's readers then read new counters
in files of their own.

A cell whose ``chips`` is over 1 runs one process a card
(``ranks.py``). Each rank's ``ctx.rank``, ``ctx.world`` and
``ctx.group`` (the process group: NCCL on cards, gloo on the CPU) are
the mode's to use; on one card they are 0, 1 and None. A barrier opens
every rank's window together, and a window over several ranks runs the
same collectives on every rank: rank 0 says when it ends. Where the
configuration states ``graph_shards`` > 1, ``ctx.graph`` is the rank's
``inputs.Shard`` (shard ``rank`` mod ``graph_shards``) and not the
whole ``inputs.Graph``; ``check`` on rank 0 takes the rows it compares
from ``inputs.feature_rows``, ``adjacency_rows`` and ``label_rows``,
which make any rows again, or has the other ranks send them in the
window. Every rank gets the same initial weights.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # the entries of end_to_end this cell reports
    per_layer: list      # the entries of per_layer this cell reports
    base: Path = HERE    # the directory of its traffic, limits and readers


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def family(metric: str) -> str:
    """The name of the reader a metric shares with others."""
    return re.split(r"\.|_per_", metric, maxsplit=1)[0]


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark(root) if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    base = root / HERE.name
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "workloads" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer,
                base)


def mode(name: str):
    """The driver module of a traffic mode, ``modes/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad mode name {name!r}")
    return importlib.import_module(f"port_bench.modes.{name}")


def reader(metric: str, base: Path = HERE):
    """The ``read(view)`` function of ``metrics/<metric>.py``, or of
    ``metrics/<family>.py`` where the metric has no file of its own."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = base / "metrics" / f"{metric}.py"
    if not path.exists():
        path = base / "metrics" / f"{family(metric)}.py"
    module_spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
