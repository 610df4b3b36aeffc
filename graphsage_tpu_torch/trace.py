"""The port's spans at its layer boundaries, and its launch counters.

``span(name)`` marks one layer's work on the calling thread:

    with trace.span("sample"):
        samples = sample_frontier(...)

Off (the default) it returns one shared object whose ``with`` does
nothing: no clock is read, no profiler range entered, nothing kept.
``enable`` turns the spans on in one of two ways, or both:

- ``record``: each span is kept in memory as a ``Span`` (name, start
  and end by ``time.time_ns``, the index of the span it lies in, its
  unit, the native thread id) until ``drain`` hands them over. A top
  span (``TOP``: a training step, an evaluation step) opens a new unit,
  and every span inside it carries that unit's number. ``time.time_ns``
  is the clock of ``torch.profiler``'s Chrome trace: an event's
  ``ts * 1e3 + baseTimeNanoseconds`` (``ts`` in microseconds) is on it.
- ``annotate``: each span is also a ``torch.profiler.record_function``
  range, so a profiler recording the host's activity shows it (the
  range encloses the span's clock reads).

The spans are (see ``PERF.md`` section 3 for what reads each):
``train.chunk`` > ``train.step`` > ``sample``, ``gather``,
``aggregate``, ``head``, ``backward``, ``optimizer`` (the supervised
chunk runner, ``parallel/dp.py``); ``eval.sweep`` > ``eval.step`` >
``sample``, ``gather``, ``aggregate``, ``head`` (``train/supervised.py``).
Every runner that calls ``models/graphsage.py::sage_embed`` has its
``sample``, ``gather`` and ``aggregate``. Nothing is spanned inside
autograd's backward worker: its work falls in ``backward`` by time.

``snapshot`` reads the kernel wrappers' launch counters (K1-K6) and
the pool backward's routes, which stay where they are counted
(``ops/gather.py``, ``ops/pool.py``).
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

TOP = ("train.step", "eval.step")


class Span(NamedTuple):
    name: str
    start_ns: int      # time.time_ns()
    end_ns: int        # None while the span is open
    parent: int        # index in the drained list of the enclosing span, -1
    unit: int          # the enclosing top span's unit, -1 outside any
    thread: int        # threading.get_native_id()


class _Thread(threading.local):
    """A thread's open spans and native id (read once: a system call,
    several microseconds on some hosts)."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


class _Off:
    """The shared span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_record = False
_annotate = False
_spans: list = []       # [name, start, end, parent entry, unit, thread]
_units = 0
_local = _Thread()


def enabled() -> bool:
    return _on


def enable(record: bool = True, annotate: bool = False) -> None:
    """Turn the spans on (outside every span): kept in memory
    (``record``), profiler ranges (``annotate``), or both. Unit numbers
    start again from 1."""
    global _on, _record, _annotate, _units
    _record, _annotate, _units = record, annotate, 0
    _on = record or annotate


def disable() -> None:
    """Turn the spans off; what was recorded stays until ``drain``."""
    global _on, _record, _annotate
    _on = _record = _annotate = False


def drain() -> list:
    """The recorded spans as ``Span``s, in the order they opened, and
    forget them."""
    global _spans
    out, _spans = _spans, []
    index = {id(e): i for i, e in enumerate(out)}
    return [Span(n, t0, t1, index.get(id(p), -1), u, th)
            for n, t0, t1, p, u, th in out]


def span(name: str):
    """A context manager marking ``name``'s work (see the module's
    docstring)."""
    if not _on:
        return _OFF
    return _On(name)


class _On:
    __slots__ = ("name", "entry", "range")

    def __init__(self, name: str):
        self.name = name
        self.entry = self.range = None

    def __enter__(self):
        # the clock is read next to the range's own enter and exit, the
        # bookkeeping kept outside them
        global _units
        if _record:
            stack = _local.stack
            parent = stack[-1] if stack else None
            if self.name in TOP:
                _units += 1
                unit = _units
            else:
                unit = parent[4] if parent is not None else -1
            self.entry = [self.name, 0, None, parent, unit, _local.tid]
            stack.append(self.entry)
            _spans.append(self.entry)
        if _annotate:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.entry is not None:
            self.entry[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[2] = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.entry is not None:
            _local.stack.pop()
        return False


def snapshot() -> dict:
    """The launch counts of the port's kernels in this process, by
    kernel: K1 (gather-mean), K2 (its Philox dropout), K3 (its dedup),
    K4 (the row gather), K5 (gather-MLP-pool) and K6 (its training
    forward); and the pool backwards by route: ``pool_grad_mask``
    (the mean's, relu' from K6's mask) and ``pool_grad_recompute``
    (the max's, z recomputed)."""
    from graphsage_tpu_torch.ops.gather import fused_gather_mean as gm
    from graphsage_tpu_torch.ops.gather import fused_gather_rows as gr
    from graphsage_tpu_torch.ops.pool import fused_gather_mlp_pool as gp
    from graphsage_tpu_torch.ops.pool import route_pool_grad as pg

    return {"K1": gm.launches, "K2": gm.dropout_launches,
            "K3": gm.dedup_launches, "K4": gr.launches,
            "K5": gp.launches, "K6": gp.train_launches,
            "pool_grad_mask": pg.mask_backwards,
            "pool_grad_recompute": pg.recomputes}
