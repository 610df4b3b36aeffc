"""One run of a cell: set-up, the measured window, the output check and
the result line.

``run_cell`` is the whole run on a device it is given; ``run.py`` is
the command, which first refuses a machine without the cards the cell
asks for. Tests call ``run_cell`` on the CPU at toy sizes, where the
port takes its kernels' plain versions.

A cell over several cards runs ``run_cell`` in one process a card
(``ranks.py`` starts them), each given its ``Ranks``: every rank makes
its inputs (its shard, where the configuration shards the graph), sets
up, meets the others at a barrier that opens every window together, and
traces its own device; after the window each rank's peak memory and
traced span are gathered to rank 0, which alone computes the end-to-end
metrics, the check and the per-layer metrics, and returns the result.
"""

from __future__ import annotations

import dataclasses
import gc
import resource
import sys
import time

import torch

from port_bench import inputs, spec
from port_bench.trace import RankTrace, Span, View

FORBIDDEN = ("jax", "jaxlib", "flax", "graphsage_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among a cell's ranks, one a card."""
    rank: int = 0
    world: int = 1
    group: object = None      # the modes' process group (NCCL on cards)
    control: object = None    # gloo: the harness's barriers and gathers
    on_window: object = None  # called on rank 0 as its window opens

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.control)

    def gather(self, obj) -> list:
        """``obj`` of every rank, in rank order."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.control)
        return out


SOLO = Ranks()


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    device: torch.device
    program: str          # "port", or "control": the reference in TF32
    graph: inputs.Graph
    params0: dict         # the initial weights; the program gets copies
    span: Span
    ranks: Ranks = SOLO

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def rank(self) -> int:
        return self.ranks.rank

    @property
    def world(self) -> int:
        return self.ranks.world

    @property
    def group(self):
        return self.ranks.group

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def params(self) -> dict:
        return {k: v.clone() for k, v in self.params0.items()}

    def sampler_generator(self) -> torch.Generator:
        return inputs.generator(self.seed, inputs.SAMPLER, self.device)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def peak_memory(device) -> int:
    """The device's peak allocation since the last reset; on the CPU,
    the process's peak resident set."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def make_inputs(cfg: dict, seed: int, rank: int, device):
    """The rank's graph: its shard where the configuration shards the
    graph (shard ``rank`` mod ``graph_shards``), else the whole."""
    if inputs.shards(cfg) > 1:
        return inputs.make_shard(cfg, seed, rank % inputs.shards(cfg),
                                 device)
    return inputs.make_graph(cfg, seed, device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, program: str = "port", t_start: float | None = None,
             build=None, on_record=None, ranks: Ranks = SOLO):
    """One run -> the result dict (``correct`` ... ``checks``, last);
    None on a rank other than 0 of several.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock
    (the command's, over several ranks); ``build`` builds the program's
    kernels (timed as set-up); ``on_record`` is handed the mode's record
    of the window."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    mode = spec.mode(cell.traffic["mode"])
    marks = [("start", time.perf_counter())]
    if build is not None:
        out = build(cell.config)
        if out:
            log(out.strip()[-4000:])
        marks.append(("build", time.perf_counter()))
    graph = make_inputs(cell.config, seed, ranks.rank, device)
    params0 = inputs.make_params(cell.config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("inputs", time.perf_counter()))
    ctx = Context(cell, seed, seconds, device, program, graph, params0,
                  Span(trace, device), ranks)
    state = mode.setup(ctx)
    ctx.span.prepare()
    if ranks.world > 1:
        log(f"set-up memory peak {peak_memory(device)} bytes")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("warm-up", time.perf_counter()))
    if ranks.world > 1:
        ranks.barrier()
        marks.append(("barrier", time.perf_counter()))
        if ranks.rank == 0 and ranks.on_window is not None:
            ranks.on_window()
    setup_s = marks[-1][1] - t_start
    log(f"set-up {setup_s:.3f} s (imports {marks[0][1] - t_start:.3f}; "
        + "; ".join(f"{n} {t - marks[i][1]:.3f}"
                    for i, (n, t) in enumerate(marks[1:]))
        + f"); window {seconds} s")

    rec = mode.window(ctx, state, seconds)
    for line in ctx.span.finish():
        log("trace: " + line)
    peak = peak_memory(device)
    if ranks.world > 1:
        log(f"memory peak {peak} bytes")
    red = ctx.span.result
    mine = (peak, None if red is None else RankTrace(
        ranks.rank, red.window_s, red.busy_s, red.device_ops))
    gathered = [mine] if ranks.world == 1 else ranks.gather(mine)
    if ranks.rank != 0:
        return None
    peak = max(p for p, _ in gathered)
    rank_traces = [t for _, t in gathered if t is not None]
    measured = mode.end_to_end(ctx, rec)
    if on_record is not None:
        on_record(rec)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = mode.check(ctx, rec)
    limits = {k: cell.limits[k] for k in numbers if k in cell.limits}
    missing = sorted(set(cell.limits) - set(numbers))
    correct = (not missing and rec["failed"] == 0
               and all(numbers[k] <= limits[k] for k in limits))

    if trace:
        metrics, breakdown, dev_extra = _per_layer(ctx, mode, rec,
                                                   rank_traces)
    else:
        measured["setup_s"] = setup_s
        metrics = {m["name"]: {"value": measured[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in measured}
        breakdown, dev_extra = None, {}
    device_entry = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": ranks.world,
        "memory_peak_bytes": int(peak), **dev_extra,
    }
    result = {"correct": bool(correct), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_entry}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k],
                            "limit": cell.limits.get(k)} for k in numbers}
    if missing:
        log(f"checks missing for limits {missing}")
    return result


def _per_layer(ctx: Context, mode, rec, rank_traces: list):
    span = ctx.span
    if span.result is None:
        log("trace: the span never closed; no per-layer metric")
        return {}, {"device_ops": [], "idle_gaps": []}, {}
    red = span.result
    info = dict(cfg=ctx.cfg, traffic=ctx.traffic,
                unit_flops=mode.unit_flops(ctx),
                hop_ids=lambda: mode.hop_ids(ctx, rec), record=rec)
    view = View(red.device_ops, red.window_s, red.busy_s, span.units, info,
                rank_traces)
    metrics = {}
    for m in ctx.cell.per_layer:
        value = spec.reader(m["name"], ctx.cell.base)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    n = len(rank_traces)
    return metrics, red.breakdown, {
        "busy_s": sum(t.busy_s for t in rank_traces) / n,
        "window_s": sum(t.window_s for t in rank_traces) / n}
