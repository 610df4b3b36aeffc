"""Supervised training through the port's chunk runner, as the trainer
drives it: the epoch's dummy-padded id stream shuffled on the device,
chunks of ``chunk_steps`` steps, each chunk ended by reading its loss to
the host (the trainer's print boundary); a new permutation each epoch.

Traffic keys: ``batch_size``, ``chunk_steps``, ``checked_steps`` (the
first steps, which the reference follows), ``trace_after_s`` (the
seconds before the first traced span, and between the two) and
``trace_chunks`` (each traced span's chunks).

End to end: ``train_edges_per_s``, the sampled edges of every chunk
whose loss was read inside the window over the time from the window's
start to the last such read.

Check: set-up runs the first chunks through the window's own call, the
runner at ``chunk_steps``, on the window's id stream, watching each
step's loss, the optimizer's state after step 1 and the parameters
after step ``checked_steps`` (as the next step reads them); the window
goes on from there with the same objects. The reference runs the
checked steps from the same weights, ids and permutations. Compared:

- ``loss_gap``: the first step's loss, relative;
- ``grad_gap`` and ``grad_gap_worst``: the gap between the norms of
  each leaf of the first gradient as Adam took it (its first moment
  after step 1), by the median leaf and by the worst (which bounds the
  leaves that only the fused gather-MLP-pool's backward writes);
- ``step_gap``: the gap between the norms of each leaf's change over
  the checked steps, by the median leaf, leaves whose reference
  gradient is under a thousandth of the median leaf's left out (they
  move by round-off alone).

Not every step's loss, nor the worst leaf's change: a relu whose input
the two sides round to opposite signs moves a leaf's gradient, the more
where a zipf hub repeats the row (id 0 is a tenth of all draws), and
Adam's first steps, about lr * sign(g), carry such a flip into the
parameters and the later losses; those swing from seed to seed by an
order of magnitude, the median leaves and the first loss do not. Every
step's losses and every leaf's readings go to standard error.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from port_bench import compare, counts, faults, inputs, program
from port_bench.harness import log
from port_bench.reference import sage

# the harness's tests: the toy size's traffic, the faults its cells can
# have (every one of faults.py)
TOY = dict(batch_size=32)
FAULTS = faults.FAULTS


def _ids_stream(ctx, gen):
    n, b = ctx.cfg["num_nodes"], ctx.traffic["batch_size"]
    steps = -(-n // b)
    padded = torch.full((steps * b,), n, dtype=torch.int32, device=ctx.device)
    padded[:n] = torch.arange(n, dtype=torch.int32, device=ctx.device)
    return padded, steps


def _shuffle(padded, gen):
    return padded[torch.randperm(padded.shape[0], generator=gen,
                                 device=padded.device)]


def setup(ctx):
    t = ctx.traffic
    prog = program.trainer(ctx.program, ctx.cfg, t["batch_size"])
    params = ctx.params()
    opt = prog.init(params)
    gen = ctx.sampler_generator()
    tgen = inputs.generator(ctx.seed, inputs.TRAFFIC, ctx.device)
    padded, steps = _ids_stream(ctx, tgen)
    perm = _shuffle(padded, tgen)
    checked, seen = t["checked_steps"], {"losses": []}

    def observe(i, loss):
        if i < checked:
            seen["losses"].append(loss.clone())
        if i == 1:
            seen["first"] = {k: v.detach().clone()
                             for k, v in prog.first_grads(opt, params).items()}
        if i == checked:
            seen["after"] = {k: v.detach().clone() for k, v in params.items()}
    done = 0
    while done <= checked:   # whole chunks, up to the step after the checked
        n = min(t["chunk_steps"], steps - done)
        float(prog.run(params, opt, gen, ctx.graph, perm, done, n, observe))
        done += n
    seen["losses"] = [float(v) for v in seen["losses"]]
    return dict(prog=prog, params=params, opt=opt, gen=gen, tgen=tgen,
                padded=padded, steps=steps, perm=perm, it=done, step=done,
                check=dict(perm0=perm, **seen))


def window(ctx, st, seconds):
    t, span = ctx.traffic, ctx.span
    prog, params, opt, gen = st["prog"], st["params"], st["opt"], st["gen"]
    perm, it, step = st["perm"], st["it"], st["step"]
    chunk, b = t["chunk_steps"], t["batch_size"]
    counted = attempted = failed = 0
    t0 = t_last = time.perf_counter()
    t_end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if it >= st["steps"]:
            perm, it = _shuffle(st["padded"], st["tgen"]), 0
        n = min(chunk, st["steps"] - it)
        if span.due(t0, t["trace_after_s"]):
            span.start()
            now = time.perf_counter()
        value = float(prog.run(params, opt, gen, ctx.graph, perm, it, n))
        done = time.perf_counter()
        span.tally(done - now, n)
        if span.open:
            for j in range(n):   # (global step, ids) of each traced step
                got = span.add((step + j, perm[(it + j) * b:(it + j + 1) * b]))
            if got >= t["trace_chunks"] * chunk:
                span.stop()
        attempted += n
        if not math.isfinite(value):
            failed += n
        if done <= t_end:
            counted, t_last = counted + n, done
        it, step = it + n, step + n
    span.stop()
    return dict(attempted=attempted, failed=failed, counted=counted,
                seconds=t_last - t0, traced=span.traced, **st["check"])


def end_to_end(ctx, rec):
    fo = (ctx.cfg["samples_1"], ctx.cfg["samples_2"])
    edges = counts.edges_per_batch(fo, ctx.traffic["batch_size"])
    if rec["counted"] == 0:
        return {}
    return {"train_edges_per_s": edges * rec["counted"] / rec["seconds"]}


def check(ctx, rec):
    cfg, g, b = ctx.cfg, ctx.graph, ctx.traffic["batch_size"]
    params = ctx.params()
    init = ctx.params()
    adam = sage.Adam(params, cfg["learning_rate"], cfg["clip"])
    stream = sage.PermStream(inputs.stream_seed(ctx.seed, inputs.SAMPLER),
                             cfg["max_degree"], ctx.device)
    ref_losses, ref_first = [], None
    with sage.precision(tf32=False):
        for i in range(len(rec["losses"])):
            value, grads = sage.loss_and_grads(
                cfg, params, g.features, g.adj, rec["perm0"][i * b:(i + 1) * b],
                g.labels_table, stream.take(2), g.num_nodes)
            if i == 0:
                ref_first = {k: v.clamp(-cfg["clip"], cfg["clip"])
                             for k, v in grads.items()}
            adam.step(params, grads)
            ref_losses.append(float(value))
    loss_gap = abs(rec["losses"][0] - ref_losses[0]) / abs(ref_losses[0])
    ref_grad = compare.norms(ref_first)
    moved = compare.moved_leaves(ref_grad)
    grad = compare.leaf_gaps(compare.norms(rec["first"]), ref_grad)
    step = compare.leaf_gaps(
        compare.norms({k: rec["after"][k] - init[k] for k in init}),
        compare.norms({k: params[k] - init[k] for k in init}), keep=moved)
    log("losses " + " ".join(f"{p!r}/{r!r}" for p, r in
                             zip(rec["losses"], ref_losses)))
    for k in grad:
        log(f"leaf {k}: gradient norm {ref_grad[k]:.6g}, gap {grad[k]:.4g}, "
            f"change gap {step.get(k, float('nan')):.4g}")
    return {"loss_gap": loss_gap,
            "grad_gap": statistics.median(grad.values()),
            "grad_gap_worst": max(grad.values()),
            "step_gap": statistics.median(step.values())}


def hop_ids(ctx, rec):
    """The innermost hop's [B * S_2, S_1] ids of each traced step."""
    cfg = ctx.cfg
    stream = sage.PermStream(inputs.stream_seed(ctx.seed, inputs.SAMPLER),
                             cfg["max_degree"], ctx.device)
    at = 0
    for step, ids in rec["traced"]:
        stream.skip(2 * (step - at))
        hops = sage.frontiers(cfg, ctx.graph.adj, ids, stream.take(2))
        at = step + 1
        yield hops[-1].view(-1, cfg["samples_1"])


def unit_flops(ctx) -> float:
    return counts.model_flops(ctx.cfg, ctx.traffic["batch_size"],
                              training=True)
