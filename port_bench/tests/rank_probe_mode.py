"""A traffic mode for the tests of cells over several ranks, written into
a checkout's ``modes/`` as a new file, as a later cell's mode would be.
It runs on every rank of a sharded graph and needs nothing of the port.

Traffic keys:

- ``probe_rows``: node ids drawn from the seed; in the window each rank
  other than 0 sends rank 0 the rows of those ids that it holds
  (features, adjacency, labels), and the check makes them again
  (``inputs.feature_rows`` ...) and counts the rows that differ by a
  bit: ``rows_differ``;
- ``whole_sum``: the shards' adjacency sums, all-reduced, against the
  sum over every row made again: ``sum_gap``;
- ``ballast_mb``: rank r holds r times as many MB through its window;
- ``trace_after_s``, ``trace_rounds``: the traced spans;
- ``fail``: ``{"rank": r, "how": ...}``, rank r in its window raises
  (``raise``), is killed (``kill``), hangs (``hang``) or loads a module
  named ``jax`` (``jax``).

``planted("altered_row")`` is its fault (``FAULTS``, named by this
module's own name, whatever file it is copied to): each rank but 0
sends one of its rows with one feature changed. ``TOY``: the toy size
of the harness's tests.

Every round of the window all-reduces one number, rank 0's word whether
the window goes on, so that every rank runs as many; end to end:
``rounds_per_s``.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import time
import types

import torch
import torch.distributed as dist

from port_bench import inputs


TOY = dict(probe_rows=200, trace_rounds=5)
FAULTS = (f"{__name__}:altered_row",)
ALTERED = []   # the planted fault, while it is planted


@contextlib.contextmanager
def planted(name: str):
    if name != "altered_row":
        raise ValueError(f"unknown fault {name!r}")
    ALTERED.append(name)
    try:
        yield
    finally:
        ALTERED.remove(name)


def _owners(ctx, ids):
    d, ss = inputs.shards(ctx.cfg), inputs.shard_size(ctx.cfg)
    if ctx.cfg.get("shard_layout", "strided") == "strided":
        return ids % d, ids // d
    return ids // ss, ids % ss


def setup(ctx):
    t, g = ctx.traffic, ctx.graph
    print(f"program {ctx.program}", file=sys.stderr)
    st = {"ballast": torch.ones(ctx.rank * t.get("ballast_mb", 0) << 18,
                                device=ctx.device)}
    if "probe_rows" in t:
        gen = inputs.generator(ctx.seed, inputs.CHECK, ctx.device)
        ids = torch.randint(0, ctx.cfg["num_nodes"] + 1, (t["probe_rows"],),
                            generator=gen, device=ctx.device)
        owner, local = _owners(ctx, ids)
        st["probe"] = [(ids[owner == r], local[owner == r])
                       for r in range(g.shards)]
    return st


def _fail(ctx):
    how = ctx.traffic.get("fail", {})
    if how.get("rank") != ctx.rank:
        return
    if how["how"] == "raise":
        raise RuntimeError(f"rank {ctx.rank} fails, as the traffic asks")
    if how["how"] == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if how["how"] == "hang":
        time.sleep(1e6)
    if how["how"] == "jax":
        sys.modules["jax"] = types.ModuleType("jax")


def _exchange(ctx, st):
    """{rank: (ids, features, adjacency, labels)}: rank 0's copies of the
    probed rows each rank holds."""
    g, got = ctx.graph, {}
    for r in range(g.shards):
        ids, local = st["probe"][r]
        if ctx.rank == r:
            held = (g.features[local], g.adj[local], g.labels[ids])
            if ALTERED and r != 0 and ids.shape[0]:
                held[0][0, 0] += 1.0
            if r == 0:
                got[r] = (ids, *held)
            for x in held if r != 0 else ():
                dist.send(x.contiguous(), 0, group=ctx.group)
        elif ctx.rank == 0:
            n = ids.shape[0]
            bufs = [g.features.new_empty((n, g.features.shape[1])),
                    g.adj.new_empty((n, g.adj.shape[1])),
                    g.labels.new_empty((n,))]
            for buf in bufs:
                dist.recv(buf, r, group=ctx.group)
            got[r] = (ids, *bufs)
    return got


def window(ctx, st, seconds):
    t, span = ctx.traffic, ctx.span
    _fail(ctx)
    rec = {"attempted": 0, "failed": 0}
    if "probe_rows" in t:
        rec["probe"] = _exchange(ctx, st)
    if t.get("whole_sum"):
        total = ctx.graph.adj.to(torch.int64).sum().view(1)
        dist.all_reduce(total, group=ctx.group)
        rec["adj_sum"] = int(total)
    go = torch.ones(1, device=ctx.device)
    t0 = time.perf_counter()
    while True:
        if span.due(t0, t.get("trace_after_s", 0.0)):
            span.start()
        # rank 0 ends the window: every rank runs as many rounds
        go.fill_(ctx.rank != 0 or time.perf_counter() - t0 < seconds)
        dist.all_reduce(go, op=dist.ReduceOp.MIN, group=ctx.group)
        if not go.item():
            break
        rec["attempted"] += 1
        if span.open and span.add(rec["attempted"]) >= t["trace_rounds"]:
            span.stop()
    span.stop()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def end_to_end(ctx, rec):
    return {"rounds_per_s": rec["attempted"] / rec["seconds"]}


def check(ctx, rec):
    cfg, dev, out = ctx.cfg, ctx.device, {}
    if "probe" in rec:
        differ = 0
        for r, (ids, f, a, lab) in sorted(rec["probe"].items()):
            same = ((inputs.feature_rows(cfg, ctx.seed, ids, dev)
                     .view(torch.int32) == f.view(torch.int32)).all(1)
                    & (inputs.adjacency_rows(cfg, ctx.seed, ids, dev)
                       == a).all(1)
                    & (inputs.label_rows(cfg, ctx.seed, ids, dev) == lab))
            print(f"rank {r}: {ids.shape[0]} probed rows, "
                  f"{int((~same).sum())} differ", file=sys.stderr)
            differ += int((~same).sum())
        out["rows_differ"] = differ
    if "adj_sum" in rec:
        every = torch.arange(cfg["num_nodes"] + 1, device=dev)
        whole = inputs.adjacency_rows(cfg, ctx.seed, every, dev)
        out["sum_gap"] = abs(int(whole.to(torch.int64).sum())
                             - rec["adj_sum"])
    return out


def hop_ids(ctx, rec):
    return iter(())


def unit_flops(ctx):
    return 0.0
