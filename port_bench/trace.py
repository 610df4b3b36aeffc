"""The traced spans of a ``--trace 1`` run and their reduction.

A mode opens the span around whole units of its traffic (steps,
batches, requests) inside the measured window, twice in turn (over
several cards, each rank on its own device):

1. ``metrics``: ``torch.profiler`` with CUDA activity alone, from a
   device synchronise to one after its last unit. The per-layer metrics
   read this span: its device operations (kernels, copies, sets), the
   union of their intervals (``busy_s``) and its length on the host's
   clock (``window_s``).
2. ``breakdown``: CPU and CUDA activity over as many units again, the
   span marked by a ``record_function`` range. It gives the idle gaps by
   what the host was doing, which needs the host's operations; their
   recording costs host time, so no metric reads this span.

The profiler's first start in a process takes seconds (CUPTI's set-up),
so ``prepare`` pays it in set-up; the second span opens ``trace_after_s``
after the first closed, so that a backlog its trace's export left has
drained. Each unit's host time is tallied by where it ran (untraced, or
in which span), so that the profiler's cost shows. Each span's Chrome
trace is written under ``TMPDIR`` as it closes (a later profiler session
overwrites the device records of an earlier one that is still held),
and read and deleted after the window.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import json
import os
import statistics
import tempfile
import time

import torch

SPAN = "port_bench.span"
PHASES = ("metrics", "breakdown")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    ts: float    # microseconds
    dur: float


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    device_ops: list     # every device Op of the metrics span
    breakdown: dict


class Span:
    """Opened and closed by a mode around its traced units, once for
    each of ``PHASES``; inert when the run is not traced."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.phase = -1      # index in PHASES of the open or last span
        self.units = 0       # the metrics span's units
        self.traced = []     # the metrics span's items
        self.result = None
        self._prof = self._range = None
        self._closed = []    # (phase, trace file, host seconds, units)
        self._stopped_at = None
        self._items, self._units = [], 0
        self._tally = {p: [] for p in ("untraced",) + PHASES}

    @property
    def pending(self) -> bool:
        """A span is still to be opened."""
        return (self.enabled and self._prof is None
                and self.phase + 1 < len(PHASES))

    @property
    def open(self) -> bool:
        return self._prof is not None

    def due(self, t0: float, after_s: float) -> bool:
        """A span is to be opened now: ``after_s`` after the window's
        start ``t0`` (the first) or after the last span closed."""
        since = t0 if self._stopped_at is None else self._stopped_at
        return self.pending and time.perf_counter() - since >= after_s

    def _activities(self, phase: str) -> list:
        from torch.profiler import ProfilerActivity

        acts = []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        if phase == "breakdown" or not acts:
            acts.append(ProfilerActivity.CPU)
        return acts

    def prepare(self) -> None:
        """Start and stop the profiler once for each span over a small
        device operation, in set-up."""
        if not self.enabled:
            return
        from torch.profiler import profile

        for phase in PHASES:
            with profile(activities=self._activities(phase)):
                torch.ones(1, device=self.device).add_(1.0)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()

    def start(self) -> None:
        if not self.pending:
            return
        from torch.profiler import profile

        self.phase += 1
        breakdown = PHASES[self.phase] == "breakdown"
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._prof = profile(activities=self._activities(PHASES[self.phase]))
        self._prof.__enter__()
        self._range = None
        if breakdown:
            self._range = torch.profiler.record_function(SPAN)
            self._range.__enter__()
        self._items, self._units = [], 0
        self._t0 = time.perf_counter()

    def add(self, item, units: int = 1) -> int:
        """Record one traced item of ``units`` units in the open span ->
        the span's items so far."""
        self._items.append(item)
        self._units += units
        return len(self._items)

    def tally(self, seconds: float, units: int) -> None:
        """A unit's host time, under the span it ran in."""
        key = PHASES[self.phase] if self.open else "untraced"
        self._tally[key].append(seconds / units)

    def stop(self) -> None:
        """Close the open span, if any."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(path)
        phase = PHASES[self.phase]
        self._closed.append((phase, path, host_s, self._units))
        if phase == "metrics":
            self.units, self.traced = self._units, self._items
        self._prof = None
        self._stopped_at = time.perf_counter()

    def finish(self) -> list:
        """Read the closed spans' traces (after the window, so that
        writing and parsing them stall nothing measured) -> lines that
        say what each span and the profiler's cost read."""
        read = {}
        for phase, path, host_s, units in self._closed:
            try:
                with open(path) as fp:
                    read[phase] = (json.load(fp)["traceEvents"], host_s,
                                   units)
            finally:
                os.remove(path)
        self._closed = []
        lines = []
        for key, t in self._tally.items():
            if t:
                lines.append(f"{key}: host ms a unit, median "
                             f"{statistics.median(t) * 1e3:.4f} over {len(t)}")
        if "metrics" not in read:
            return lines
        events, host_s, units = read["metrics"]
        ops, busy_s = device_busy(events)
        by_name = collections.Counter()
        for o in ops:
            by_name[o.name] += o.dur
        gaps = []
        if "breakdown" in read:
            b_events, b_host_s, b_units = read["breakdown"]
            b_window, b_busy, gaps = idle_gaps(b_events, b_host_s)
            lines.append(f"breakdown span: {b_units} units in {b_window:.6f}"
                         f" s, busy {b_busy:.6f} s")
        lines.append(f"metrics span: {units} units in {host_s:.6f} s, busy "
                     f"{busy_s:.6f} s, {len(ops)} device operations")
        breakdown = {
            "device_ops": [[n[:160], t / 1e6]
                           for n, t in by_name.most_common(10)],
            "idle_gaps": [[n[:160], t] for n, t in gaps[:10]],
        }
        self.result = Reduced(host_s, busy_s, ops, breakdown)
        return lines


def _ops(events) -> list:
    return [Op(e.get("name", "?"), e.get("cat", ""), float(e["ts"]),
               float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X" and "ts" in e]


def device_busy(events: list):
    """(every device operation, the seconds in which one ran) of a span
    traced from a device synchronise to the next."""
    ops = [o for o in _ops(events) if o.cat in DEVICE_CATS]
    busy = _union((o.ts, o.ts + o.dur) for o in ops)
    return ops, sum(e - s for s, e in busy) / 1e6


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_activity(host_ops, times) -> list:
    """The innermost host operation running at each of ``times``
    (ascending): the latest-started one that has not ended."""
    ordered = sorted(host_ops, key=lambda o: o.ts)
    heap, out, i = [], [], 0
    for t in times:
        while i < len(ordered) and ordered[i].ts <= t:
            o = ordered[i]
            heapq.heappush(heap, (-o.ts, o.ts + o.dur, o.name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host: no traced op")
    return out


def idle_gaps(events: list, host_s: float):
    """(span seconds, busy seconds, [(host activity, idle seconds)]
    longest first) of a span traced with the host's operations, marked
    by the ``SPAN`` range."""
    ops = _ops(events)
    spans = [o for o in ops if o.name == SPAN and o.cat == "user_annotation"]
    if spans:
        w0, w1 = spans[0].ts, spans[0].ts + spans[0].dur
    else:   # no annotation recorded: the span's host length from its ops
        w0 = min((o.ts for o in ops), default=0.0)
        w1 = w0 + host_s * 1e6
    busy = _union((max(o.ts, w0), min(o.ts + o.dur, w1)) for o in ops
                  if o.cat in DEVICE_CATS and o.ts < w1 and o.ts + o.dur > w0)
    holes, last = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > last:
            holes.append((last, s))
        last = max(last, e)
    host = [o for o in ops if o.cat in HOST_CATS and o.name != SPAN]
    gaps = collections.Counter()
    names = _host_activity(host, [(s + e) / 2 for s, e in holes])
    for (s, e), name in zip(holes, names):
        gaps[name] += e - s
    return ((w1 - w0) / 1e6, sum(e - s for s, e in busy) / 1e6,
            [(n, t / 1e6) for n, t in gaps.most_common()])


@dataclasses.dataclass
class RankTrace:
    """One rank's metrics span: its length by the host's clock, its
    busy seconds and its device operations."""

    rank: int
    window_s: float
    busy_s: float
    device_ops: list


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader reads: rank 0's metrics span's
    device operations and kernels, its length and busy time, its units
    and their description (``info``: the cell's configuration and
    traffic, the model FLOPs of a unit, ``hop_ids()``, the innermost
    hop's ids of each of the span's units, replayed from the seed, and
    ``record``, the mode's record of the window, for readings by the
    host's clock), and ``ranks``, every rank's ``RankTrace`` (rank 0's
    alone on one card), gathered after the window, so that a cell over
    several cards can read its slowest rank."""

    device_ops: list
    window_s: float
    busy_s: float
    units: int
    info: dict
    ranks: list = dataclasses.field(default_factory=list)

    @property
    def kernels(self) -> list:
        return [o for o in self.device_ops if o.cat == "kernel"]

    def matching(self, pattern) -> list:
        """The kernels whose names ``pattern`` (a compiled regex)
        finds."""
        return [o for o in self.kernels if pattern.search(o.name)]

    def roofline_share(self, launches: list, extra: list, least_s) -> float:
        """100 x the mean least time of a launch (``least_s(idx)`` over
        the units' innermost-hop ids) / its mean device time, the
        ``extra`` kernels a launch also runs counted in; None without a
        launch."""
        if not launches:
            return None
        bounds = [least_s(idx) for idx in self.info["hop_ids"]()]
        seconds = (sum(o.dur for o in launches + extra) / len(launches)
                   / 1e6)
        if seconds <= 0:
            return None
        return 100.0 * (sum(bounds) / len(bounds)) / seconds
