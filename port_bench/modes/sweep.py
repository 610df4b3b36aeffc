"""Whole-graph prediction: the port's evaluation sweep over every node
in batches of ``batch_size`` (the id stream dummy-padded to whole
batches), each sweep ended by copying every node's predictions to the
host, as ``train/supervised.py::_run_eval_sweep`` does.

Traffic keys: ``batch_size``, ``checked_sweeps`` (how many of the
window's sweeps the reference checks, drawn from the seed),
``trace_after_s`` (the seconds before the first traced span, and
between the two) and ``trace_sweeps``.

End to end: ``infer_nodes_per_s``, the real nodes of every sweep whose
predictions reached the host inside the window over the time from the
window's start to the last such copy.

Check: every real node of the checked sweeps against the reference,
which replays each batch's permutations: ``pred_gap``, the widest gap
between the program's log predictions and the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import compare, counts, inputs, program
from port_bench.reference import sage


def _host_sweep(st, ctx):
    losses, preds = st["prog"].sweep(st["params"], ctx.graph, st["ids_all"],
                                     st["gen"])
    host = torch.cat([losses, preds.reshape(-1)]).cpu().numpy()
    n_b = st["n_b"]
    return host[n_b:].reshape(n_b * ctx.traffic["batch_size"], -1)[
        :ctx.cfg["num_nodes"]]


def setup(ctx):
    b, n = ctx.traffic["batch_size"], ctx.cfg["num_nodes"]
    n_b = -(-n // b)
    ids_all = torch.full((n_b * b,), n, dtype=torch.int32, device=ctx.device)
    ids_all[:n] = torch.arange(n, dtype=torch.int32, device=ctx.device)
    st = dict(prog=program.evaluator(ctx.program, ctx.cfg, b),
              params=ctx.params(), gen=ctx.sampler_generator(),
              ids_all=ids_all, n_b=n_b)
    _host_sweep(st, ctx)             # warm-up: sweep 0
    return st


def window(ctx, st, seconds):
    t, span = ctx.traffic, ctx.span
    keep = t["checked_sweeps"]
    rng = inputs.host_rng(ctx.seed, inputs.CHECK)
    kept = []
    counted = attempted = 0
    sweep = 1                        # sweeps drawn from the generator
    t0 = t_last = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if span.due(t0, t["trace_after_s"]):
            span.start()
            now = time.perf_counter()
        preds = _host_sweep(st, ctx)
        done = time.perf_counter()
        span.tally(done - now, st["n_b"])
        if span.open and span.add(sweep, st["n_b"]) >= t["trace_sweeps"]:
            span.stop()
        # a reservoir of ``keep`` sweeps, drawn from the seed
        j = attempted
        if j < keep:
            kept.append((sweep, preds))
        else:
            r = int(rng.integers(0, j + 1))
            if r < keep:
                kept[r] = (sweep, preds)
        attempted += 1
        if done <= t_end:
            counted, t_last = counted + 1, done
        sweep += 1
    span.stop()
    return dict(attempted=attempted, failed=0, counted=counted,
                seconds=t_last - t0, kept=sorted(kept, key=lambda k: k[0]),
                traced=span.traced, ids_all=st["ids_all"], n_b=st["n_b"])


def end_to_end(ctx, rec):
    if rec["counted"] == 0:
        return {}
    return {"infer_nodes_per_s":
            ctx.cfg["num_nodes"] * rec["counted"] / rec["seconds"]}


def _batches(ctx, rec, sweeps):
    """(sweep, batch index, ids, permutations) of each batch of the
    given sweeps (ascending), the permutations replayed."""
    b = ctx.traffic["batch_size"]
    stream = sage.PermStream(inputs.stream_seed(ctx.seed, inputs.SAMPLER),
                             ctx.cfg["max_degree"], ctx.device)
    at = 0
    for s in sweeps:
        stream.skip(2 * rec["n_b"] * (s - at))
        for k in range(rec["n_b"]):
            yield s, k, rec["ids_all"][k * b:(k + 1) * b], stream.take(2)
        at = s + 1


def check(ctx, rec):
    b, n = ctx.traffic["batch_size"], ctx.cfg["num_nodes"]
    preds = dict(rec["kept"])
    gap = 0.0
    with sage.precision(tf32=False):
        for s, k, ids, perms in _batches(ctx, rec, sorted(preds)):
            real = int(min(b, n - k * b))
            ref = sage.log_predictions(ctx.cfg, ctx.params0, ctx.graph.features,
                                       ctx.graph.adj, ids[:real], perms)
            got = torch.from_numpy(np.ascontiguousarray(
                preds[s][k * b:k * b + real])).to(ctx.device)
            gap = max(gap, compare.log_gap(got, ref))
    return {"pred_gap": gap}


def hop_ids(ctx, rec):
    for _, _, ids, perms in _batches(ctx, rec, rec["traced"]):
        hops = sage.frontiers(ctx.cfg, ctx.graph.adj, ids, perms)
        yield hops[-1].view(-1, ctx.cfg["samples_1"])


def unit_flops(ctx) -> float:
    return counts.model_flops(ctx.cfg, ctx.traffic["batch_size"],
                              training=False)
