"""An open loop of independent requests: each asks for the class
predictions of ``batch_size`` nodes drawn uniformly; Poisson arrivals
at ``rate_per_s`` a second, conditioned on their count: the window's
round(rate * seconds) arrival times are uniform draws from the seed,
sorted (the gaps are then i.i.d. exponential but for the fixed total,
so every seed offers the same number of requests). One request at a
time, oldest first, through the port's evaluation step, its predictions
copied to the host.

Traffic keys: ``batch_size``, ``rate_per_s``, ``warmup_requests``
(served back to back in set-up), ``checked_requests`` (drawn from the
seed among the window's), ``late_s`` (how long past the window's close
the loop keeps serving the requests due in it), ``trace_after_s`` (the
seconds before the first traced span, and between the two: long enough
for the backlog that writing the first span's trace leaves to drain)
and ``trace_requests``.

End to end: ``request_service_ms``, the server's busy time per request:
the sum over every request due in the window of (predictions on the
host - the start of its service), over their count. A request not
served ``late_s`` after the close never came: it counts as failed.

Per layer (``--trace 1``): ``request_p95_ms.requests``, the 95th
percentile of (predictions on the host - scheduled arrival) over the
requests due before the first traced span opens, so that the
profiler's cost is not in it. At 0.8 of the knee the queue multiplies
a change of the service time several times over in this tail, so it is
read, not bounded.

Check: the checked requests against the reference, which replays their
permutations: ``pred_gap``, the widest gap between the program's log
predictions and the reference's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench import compare, counts, inputs, program
from port_bench.harness import log
from port_bench.reference import sage

# the harness's tests: the toy size's traffic, the faults its cells can
# have (faults.py)
TOY = dict(batch_size=16, rate_per_s=100, warmup_requests=3,
           checked_requests=5, trace_requests=10)
FAULTS = ("half_neighbours", "altered_answer")


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times in [0, seconds] of round(rate * seconds) requests: a
    Poisson process at ``rate`` given its count, i.e. that many uniform
    draws, sorted."""
    n = max(1, round(rate * seconds))
    rng = inputs.host_rng(seed, inputs.TRAFFIC)
    return np.sort(rng.uniform(0.0, seconds, n))


def setup(ctx):
    t, n = ctx.traffic, ctx.cfg["num_nodes"]
    b, warm = t["batch_size"], t["warmup_requests"]
    arrivals = schedule(t["rate_per_s"], ctx.seconds, ctx.seed)
    tgen = inputs.generator(ctx.seed, inputs.TRAFFIC, ctx.device)
    ids = torch.randint(0, n, (warm + len(arrivals), b), generator=tgen,
                        dtype=torch.int32, device=ctx.device)
    rng = inputs.host_rng(ctx.seed, inputs.CHECK)
    checked = rng.choice(len(arrivals), size=min(t["checked_requests"],
                                                 len(arrivals)),
                         replace=False)
    st = dict(prog=program.evaluator(ctx.program, ctx.cfg, b),
              params=ctx.params(), gen=ctx.sampler_generator(), ids=ids,
              mask=torch.ones(b, device=ctx.device), arrivals=arrivals,
              checked=set(int(i) for i in checked))
    for i in range(warm):
        _serve(st, ctx, i)
    return st


def _serve(st, ctx, row):
    _, preds = st["prog"].request(st["params"], ctx.graph, st["ids"][row],
                                  st["mask"], st["gen"])
    return preds.cpu()


def _wait_until(t: float) -> None:
    """Spin to ``t``, sleeping first only through long gaps: a sleep can
    wake late by a millisecond or more on a busy host."""
    delay = t - time.perf_counter()
    if delay > 5e-3:
        time.sleep(delay - 3e-3)
    while time.perf_counter() < t:
        pass


def window(ctx, st, seconds):
    t, span = ctx.traffic, ctx.span
    warm, arrivals = t["warmup_requests"], st["arrivals"]
    n = len(arrivals)
    lat = np.full(n, np.nan)
    service = np.full(n, np.nan)
    slip = np.zeros(n)
    finish = np.zeros(n)
    kept = {}
    # the server keeps set-up's objects out of the collector's full
    # passes, which would stall the loop for tens of milliseconds
    gc.freeze()
    collections = [s["collections"] for s in gc.get_stats()]
    t0 = time.perf_counter()
    cutoff = t0 + seconds + t["late_s"]
    free = t0
    untraced = n         # the requests before the first traced span
    for i in range(n):
        due = t0 + arrivals[i]
        if time.perf_counter() > cutoff:
            break
        _wait_until(due)
        start = time.perf_counter()
        if span.due(t0, t["trace_after_s"]):
            untraced = min(untraced, i)
            span.start()
        begun = time.perf_counter()
        preds = _serve(st, ctx, warm + i)
        done = time.perf_counter()
        span.tally(done - begun, 1)
        lat[i], finish[i] = done - due, done - t0
        service[i] = done - begun
        slip[i] = start - max(due, free)
        free = done
        if i in st["checked"]:
            kept[i] = preds
        if span.open and span.add(i) >= t["trace_requests"]:
            span.stop()
    span.stop()
    collections = [s["collections"] - c
                   for s, c in zip(gc.get_stats(), collections)]
    gc.unfreeze()
    served = ~np.isnan(lat)
    wait = lat[served]
    log(f"requests: {n} due, {int(served.sum())} served, "
        f"{int((finish[served] > seconds).sum())} done "
        f"after the close; latency p50 {np.median(wait) * 1e3:.4f} ms, "
        f"p95 {np.percentile(wait, 95) * 1e3:.4f} ms; service mean "
        f"{np.nanmean(service) * 1e3:.4f} ms; "
        f"loop start late by p50 {np.median(slip[served]) * 1e3:.4f} ms, "
        f"p99 {np.percentile(slip[served], 99) * 1e3:.4f} ms, max "
        f"{slip[served].max() * 1e3:.4f} ms; collections by generation "
        f"{collections}")
    head = lat[:untraced]
    return dict(attempted=n, failed=int(n - served.sum()), lat=wait,
                service=service[served], untraced_lat=head[~np.isnan(head)],
                kept=kept, traced=span.traced, ids=st["ids"], warm=warm)


def end_to_end(ctx, rec):
    if len(rec["service"]) == 0:
        return {}
    return {"request_service_ms": float(rec["service"].mean()) * 1e3}


def _requests(ctx, rec, rows):
    """(row, ids, permutations) of the given request rows (ascending,
    counted from the first warm-up request), replayed."""
    stream = sage.PermStream(inputs.stream_seed(ctx.seed, inputs.SAMPLER),
                             ctx.cfg["max_degree"], ctx.device)
    at = 0
    for r in rows:
        stream.skip(2 * (r - at))
        yield r, rec["ids"][r], stream.take(2)
        at = r + 1


def check(ctx, rec):
    warm, gap = rec["warm"], 0.0
    with sage.precision(tf32=False):
        for r, ids, perms in _requests(
                ctx, rec, [warm + i for i in sorted(rec["kept"])]):
            ref = sage.log_predictions(ctx.cfg, ctx.params0, ctx.graph.features,
                                       ctx.graph.adj, ids, perms)
            got = rec["kept"][r - warm].to(ctx.device)
            gap = max(gap, compare.log_gap(got, ref))
    return {"pred_gap": gap}


def hop_ids(ctx, rec):
    rows = [rec["warm"] + i for i in rec["traced"]]
    for _, ids, perms in _requests(ctx, rec, rows):
        hops = sage.frontiers(ctx.cfg, ctx.graph.adj, ids, perms)
        yield hops[-1].view(-1, ctx.cfg["samples_1"])


def unit_flops(ctx) -> float:
    return counts.model_flops(ctx.cfg, ctx.traffic["batch_size"],
                              training=False)
