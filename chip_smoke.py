#!/usr/bin/env python3
"""Drive the PyTorch port (graphsage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases; any failure exits non-zero without the final ok line:
  1. the card: nvidia-smi's name and power limit; TF32 off, as the
     parity tests' "highest" matmul precision
  2. build the CUDA kernels from the checkout's sources (nvcc)
  3. each kernel against its plain PyTorch version on the card, at the
     hop's shapes (f32 and bf16) and ragged ones; kernel, plain and
     library-call times beside the kernel's bound. K1 is the gather-mean,
     K2 the gather-mean with Philox dropout (identical masks, equal
     means, the rate's zero fraction, the 1/keep scale)
  4. serving at full width, bench.py's model: 100k nodes, 602 features,
     41 classes, fanouts 25/10, dims 128/128, batch 512, zipf(1.05)
     adjacency, seeded random weights. The eval sweep answers every node
     (196 requests of 512); K1 must launch once per batch. Checks the
     predictions and their agreement with the unfused path, then times
     requests one by one and profiles one sweep
  5. ``python -m graphsage_tpu_torch predict`` on a small synthetic
     dataset from a port checkpoint, held against the CPU path
  6. training at full width: the same model and data with dropout 0.5
     and Adam at lr 1e-2 (benchmarks/agg_sweep.py's "mean_drop"),
     through the chunk runner: three timed chunks of 50 steps (s/step,
     edges/s), K2 once per step, the loss finite at every chunk end, the
     host synchronisations per step, and a profile of a few steps
  7. fused vs unfused training at dropout 0 (K1 against the plain
     gather): equal params after a few steps from the same state
  8. ``python -m graphsage_tpu_torch supervised`` on the card against
     the same training on the CPU (first_k, dropout 0): every logged
     train loss and the final val loss agree
  9. one JSON line of per-kernel numbers, then the ok line (last)

Needs no network and one card; builds into build/kernels/.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_NODES = 100_000
FEAT_DIM = 602
NUM_CLASSES = 41
MAX_DEGREE = 128
BATCH = 512
FANOUTS = (25, 10)
DIMS = (128, 128)
HOP_ROWS = BATCH * FANOUTS[1]          # 5120 rows of the innermost hop
HBM_BYTES_PER_S = 3.35e12              # H100 SXM device memory
F32_OPS_PER_S = 67e12                  # H100 SXM f32, outside tensor cores
# H100 SXM int32: 132 SMs x 64 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2's integer instructions per element, counted from its source: one
# Philox4x32-10 call per 4 elements = 10 rounds x (2 32x32->64 multiplies
# + 2 three-input XORs) = 40 (the key schedule is warp-uniform), plus
# one compare per element
K2_INT_OPS_PER_ELEM = 40 / 4 + 1
K2_F32_OPS_PER_ELEM = 2                # scale multiply, add
F32_TOL = 1e-5                         # max abs error, kernel vs plain
BF16_REL_TOL = 2e-2                    # max error / max |plain|
DROPOUT = 0.5                          # agg_sweep.py's "mean_drop"
LEARNING_RATE = 1e-2
EDGES_PER_STEP = BATCH * (FANOUTS[1] + FANOUTS[1] * FANOUTS[0])  # 133120
TRAIN_CHUNK = 50                       # steps per timed chunk
CLI_TOL = 1e-4                         # card vs CPU training losses
ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events. The
    timed calls queue up behind a spin kernel, so the host's per-call
    launch overhead does not pace the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def zipf_ids(rng, size, alpha: float = 1.05) -> np.ndarray:
    """Node ids drawn zipf over degree-ordered ids (id 0 is the biggest
    hub), as bench.py draws its adjacency."""
    p = np.arange(1, NUM_NODES + 1, dtype=np.float64) ** -alpha
    return rng.choice(NUM_NODES, size=size, p=p / p.sum()).astype(np.int32)


# ------------------------------------------------------------ phase 1

def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3

def check_gather_mean(dev, card_line: str) -> dict:
    """K1 against its plain version; its times and bound at the hop."""
    import torch
    import torch.nn.functional as fnn

    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(NUM_NODES + 1, FEAT_DIM, generator=gen, device=dev)
    table[NUM_NODES] = 0
    rng = np.random.default_rng(1)
    # several idx sets, cycled, so that repeated timing launches do not
    # find one set's rows in L2 more often than a sweep would
    idx_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                .to(dev) for _ in range(8)]

    f32_err = 0.0
    bf16_err = 0.0
    table_bf16 = table.to(torch.bfloat16)
    for idx in idx_sets[:2]:
        out = fused_gather_mean(table, idx)
        ref = gather_mean_reference(table, idx)
        f32_err = max(f32_err, float((out - ref).abs().max()))
        out = fused_gather_mean(table_bf16, idx)
        ref = gather_mean_reference(table_bf16, idx)
        bf16_err = max(bf16_err, float((out - ref).abs().max()
                                       / ref.abs().max()))
    for F in (1, 3, 602, 640):
        small = torch.randn(65, F, generator=gen, device=dev)
        small[64] = 0
        cases = [torch.full((1, 1), 64, dtype=torch.int32, device=dev),
                 torch.randint(0, 65, (3, 5), generator=gen, device=dev,
                               dtype=torch.int32)]
        for idx in cases:
            out = fused_gather_mean(small, idx)
            ref = gather_mean_reference(small, idx)
            f32_err = max(f32_err, float((out - ref).abs().max()))
            out16 = fused_gather_mean(small.to(torch.bfloat16), idx)
            ref16 = gather_mean_reference(small.to(torch.bfloat16), idx)
            scale = max(float(ref16.abs().max()), 1e-30)
            bf16_err = max(bf16_err,
                           float((out16 - ref16).abs().max()) / scale)
        check(bool((fused_gather_mean(small, cases[0]) == 0).all()),
              f"gather_mean: the dummy row did not give zeros at F={F}")
    torch.cuda.synchronize()
    log(f"gather_mean vs plain: f32 max abs err {f32_err:.3e} "
        f"(limit {F32_TOL}), bf16 max rel err {bf16_err:.3e} "
        f"(limit {BF16_REL_TOL})")
    check(f32_err <= F32_TOL, f"gather_mean f32 error {f32_err} > {F32_TOL}")
    check(bf16_err <= BF16_REL_TOL,
          f"gather_mean bf16 error {bf16_err} > {BF16_REL_TOL}")

    def cycling(fn):
        state = {"i": 0}

        def call():
            fn(idx_sets[state["i"] % len(idx_sets)])
            state["i"] += 1
        return call

    ms = cuda_ms(cycling(lambda idx: fused_gather_mean(table, idx)))
    plain_ms = cuda_ms(cycling(lambda idx: gather_mean_reference(table, idx)))
    library_ms = cuda_ms(cycling(
        lambda idx: fnn.embedding_bag(idx, table, mode="mean")))
    bf16_ms = cuda_ms(cycling(lambda idx: fused_gather_mean(table_bf16, idx)))

    bounds = []
    for idx in idx_sets:
        distinct = int(torch.unique(idx).numel())
        n_bytes = (distinct * FEAT_DIM * 4 + HOP_ROWS * FEAT_DIM * 4
                   + idx.numel() * 4)
        n_ops = HOP_ROWS * FANOUTS[0] * FEAT_DIM + HOP_ROWS * FEAT_DIM
        bounds.append((n_bytes / HBM_BYTES_PER_S * 1e3,
                       n_ops / F32_OPS_PER_S * 1e3, distinct))
    bytes_ms = float(np.mean([b[0] for b in bounds]))
    ops_ms = float(np.mean([b[1] for b in bounds]))
    distinct = float(np.mean([b[2] for b in bounds]))
    log(f"gather_mean at idx [{HOP_ROWS},{FANOUTS[0]}] into "
        f"[{NUM_NODES + 1},{FEAT_DIM}] f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, embedding_bag {library_ms:.4f} ms, bf16 table "
        f"{bf16_ms:.4f} ms; {distinct:.0f} distinct rows per launch; bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, ops "
        f"{ops_ms:.4f}); bound share {max(bytes_ms, ops_ms) / ms:.3f}; "
        f"on {card_line}")
    return {
        "name": "gather_mean",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mean.cu",
        "replaces": "graphsage_tpu/ops/gather.py:160",
        "launches": None,
        "max_abs_err": f32_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def check_gather_mean_dropout(dev, card_line: str) -> dict:
    """K2 against its plain version under the same seed, step and tag;
    its statistics at rate 0.5; its times and bounds at the hop."""
    import torch

    from graphsage_tpu_torch.models.graphsage import KERNEL_DROP_TAG
    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_dropout_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn(NUM_NODES + 1, FEAT_DIM, generator=gen, device=dev)
    table[NUM_NODES] = 0
    rng = np.random.default_rng(3)
    idx_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                .to(dev) for _ in range(8)]
    key = dict(seed=0x0123456789ABCDEF, offset=(17, KERNEL_DROP_TAG))

    err = {}
    for name, tab in (("f32", table), ("bf16", table.to(torch.bfloat16))):
        idx = idx_sets[0]
        out = fused_gather_mean(tab, idx, DROPOUT, **key)
        ref = gather_mean_dropout_reference(tab, idx, DROPOUT, **key)
        err[name] = float((out - ref).abs().max())
        # the mask itself: one sample per row, the same elements
        flat = idx.reshape(-1, 1)
        got = fused_gather_mean(tab, flat, DROPOUT, **key) == 0
        want = gather_mean_dropout_reference(tab, flat, DROPOUT, **key) == 0
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"K2 {name}: {n_diff} mask elements differ")
        check(err[name] <= F32_TOL,
              f"K2 {name} error {err[name]} > {F32_TOL}")
        del got, want, out, ref
    log(f"K2 vs plain at idx [{HOP_ROWS},{FANOUTS[0]}]: masks identical "
        f"({HOP_ROWS * FANOUTS[0] * FEAT_DIM} elements, f32 and bf16 "
        f"tables); max abs err f32 {err['f32']:.3e}, bf16 {err['bf16']:.3e} "
        f"(limit {F32_TOL})")

    ones = torch.ones(64, FEAT_DIM, device=dev)
    s1 = torch.from_numpy(rng.integers(0, 64, (HOP_ROWS, 1),
                                       dtype=np.int32)).to(dev)
    out = fused_gather_mean(ones, s1, DROPOUT, **key)
    zero_frac = float((out == 0).float().mean())
    kept = out[out != 0]
    scale_ok = bool((kept == float(np.float32(1 / (1 - DROPOUT)))).all())
    other = fused_gather_mean(ones, s1, DROPOUT, seed=key["seed"],
                              offset=(18, KERNEL_DROP_TAG))
    steps_differ = not torch.equal(out == 0, other == 0)
    log(f"K2 at rate {DROPOUT}, all-ones table, S=1, {out.numel()} "
        f"elements: zero fraction {zero_frac:.5f} (limit +-0.005), kept "
        f"values all 1/keep: {scale_ok}, step 17 vs 18 masks differ: "
        f"{steps_differ}")
    check(abs(zero_frac - DROPOUT) <= 0.005, f"K2 zero fraction {zero_frac}")
    check(scale_ok, "K2 kept values are not 1/keep")
    check(steps_differ, "K2 gave the same mask for two steps")

    def cycling(fn):
        state = {"i": 0}

        def call():
            fn(idx_sets[state["i"] % len(idx_sets)])
            state["i"] += 1
        return call

    ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(table, idx, DROPOUT, **key)))
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mean_dropout_reference(table, idx, DROPOUT,
                                                  **key)),
        iters=5, warmup=1)
    table_bf16 = table.to(torch.bfloat16)
    bf16_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(table_bf16, idx, DROPOUT, **key)))

    elements = HOP_ROWS * FANOUTS[0] * FEAT_DIM
    bytes_ms = float(np.mean([
        (int(torch.unique(idx).numel()) * FEAT_DIM * 4
         + HOP_ROWS * FEAT_DIM * 4 + idx.numel() * 4) / HBM_BYTES_PER_S * 1e3
        for idx in idx_sets]))
    int_ms = elements * K2_INT_OPS_PER_ELEM / INT32_OPS_PER_S * 1e3
    f32_ms = elements * K2_F32_OPS_PER_ELEM / F32_OPS_PER_S * 1e3
    ops_ms = max(int_ms, f32_ms)
    bound_ms = max(bytes_ms, ops_ms)
    log(f"K2 at idx [{HOP_ROWS},{FANOUTS[0]}] into [{NUM_NODES + 1},"
        f"{FEAT_DIM}] f32, rate {DROPOUT}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bf16 table {bf16_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f}; int32 {int_ms:.4f} at "
        f"{K2_INT_OPS_PER_ELEM:g} per element and {INT32_OPS_PER_S:.4g}/s; "
        f"f32 {f32_ms:.4f}); bound share {bound_ms / ms:.3f}; library: none "
        f"(no single PyTorch call draws a per-element mask inside a "
        f"gather-mean); on {card_line}")
    return {
        "name": "gather_mean_dropout",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mean.cu",
        "replaces": "graphsage_tpu/ops/gather.py:136",
        "launches": None,
        "max_abs_err": max(err.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def sass_summary() -> None:
    """Static instruction counts of K2 (f32, 2 elements per load) from
    cuobjdump, where the toolkit has it: the record behind
    K2_INT_OPS_PER_ELEM."""
    from graphsage_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS summary")
        return
    lib = build.BUILD_DIR / "libgather_mean.so"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=False).stdout
    for block in out.split("Function : ")[1:]:
        if "gather_mean_dropout_kernelIfLi2E" not in block.split("\n")[0]:
            continue
        ops = []
        for line in block.splitlines():
            text = line.split("*/", 1)[1] if "*/" in line else ""
            words = text.replace(";", " ").split()
            if line.strip().startswith("/*") and words:
                ops.append(words[1] if words[0].startswith("@") else words[0])
        counts = {}
        for op in ops:
            counts[op] = counts.get(op, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
        log(f"SASS of K2<float,2>: {len(ops)} instructions; "
            + ", ".join(f"{k} {v}" for k, v in top))


# ------------------------------------------------------------ phase 4

def bench_data(dev):
    """bench.py's graph at full width, made on the host from seed 0 and
    moved once: (features [N+1, F] f32 with the zero dummy row, zipf
    adjacency [N+1, 128] int32, one-hot labels [N, C] on the host)."""
    import torch

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((NUM_NODES, FEAT_DIM)).astype(np.float32)
    adj_np = zipf_ids(rng, (NUM_NODES + 1, MAX_DEGREE))
    adj_np[NUM_NODES] = NUM_NODES   # the dummy node points at itself
    labels_np = np.eye(NUM_CLASSES, dtype=np.float32)[
        rng.integers(0, NUM_CLASSES, NUM_NODES)]
    features = torch.from_numpy(feats).to(dev)
    features = torch.cat([features, features.new_zeros(1, FEAT_DIM)])
    return features, torch.from_numpy(adj_np).to(dev), labels_np


def bench_config(fused: bool, dropout: float = 0.0):
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
    from graphsage_tpu_torch.models.supervised import SupervisedConfig

    sage = SAGEConfig(
        layers=(LayerInfo(FANOUTS[0], DIMS[0]),
                LayerInfo(FANOUTS[1], DIMS[1])),
        feature_dim=FEAT_DIM, aggregator="mean", concat=True,
        num_nodes=NUM_NODES, sampler_mode="shared_perm",
        fused_gather=fused, dropout=dropout)
    return SupervisedConfig(sage=sage, num_classes=NUM_CLASSES)


def serve_full_width(dev, data) -> int:
    """The eval sweep over all 100k nodes; returns K1's launch count."""
    import torch

    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.ops.gather import fused_gather_mean
    from graphsage_tpu_torch.train.metrics import calc_f1
    from graphsage_tpu_torch.train.supervised import (
        _run_eval_sweep as run_eval_sweep,
    )
    from graphsage_tpu_torch.train.supervised import make_eval_sweep

    features, adj, labels_np = data
    config = bench_config
    params = init_supervised_params(torch.Generator().manual_seed(0),
                                    config(True), device=dev)
    sweep = make_eval_sweep(config(True), BATCH, NUM_NODES)
    nodes = np.arange(NUM_NODES)
    n_b = -(-NUM_NODES // BATCH)

    def generator():
        return torch.Generator(device=dev).manual_seed(1)

    run_eval_sweep(sweep, params, features, adj, nodes[:2 * BATCH],
                   labels_np, BATCH, NUM_NODES, generator())   # warm-up

    fused_gather_mean.launches = 0
    fused_gather_mean.dropout_launches = 0
    loss, preds, labels, dt = run_eval_sweep(
        sweep, params, features, adj, nodes, labels_np, BATCH, NUM_NODES,
        generator())
    launches = fused_gather_mean.launches
    k2 = fused_gather_mean.dropout_launches

    log(f"served {NUM_NODES} nodes in {n_b} batches of {BATCH}: "
        f"{dt * 1e3:.2f} ms, {NUM_NODES / dt:.1f} nodes/s; gather_mean "
        f"launches {launches} (K2 {k2})")
    check(launches == n_b and k2 == 0,
          f"gather_mean launched {launches} times (K2 {k2}) for {n_b} "
          f"batches")
    check(preds.shape == (NUM_NODES, NUM_CLASSES),
          f"preds shape {preds.shape}")
    check(bool(np.isfinite(preds).all()) and np.isfinite(loss),
          "non-finite predictions or loss")
    row_sums = preds.sum(axis=1)
    check(bool(np.abs(row_sums - 1.0).max() < 1e-4),
          "softmax rows do not sum to 1")
    f1_mic, f1_mac = calc_f1(labels, preds, False)
    log(f"loss {loss:.5f}, f1_micro {f1_mic:.5f}, f1_macro {f1_mac:.5f} "
        f"(random weights and labels: chance is ~{1 / NUM_CLASSES:.4f})")

    # the same first batches through the plain gather path (same sampler
    # stream, hence the same samples) give the same predictions
    n_ref = 4 * BATCH
    _, ref_preds, _, _ = run_eval_sweep(
        make_eval_sweep(config(False), BATCH, NUM_NODES), params, features,
        adj, nodes[:n_ref], labels_np, BATCH, NUM_NODES, generator())
    diff = float(np.abs(ref_preds - preds[:n_ref]).max())
    log(f"fused vs unfused path, first {n_ref} nodes: max abs diff "
        f"{diff:.3e} (limit 1e-5)")
    check(diff <= 1e-5, f"fused and unfused predictions differ by {diff}")

    for rep in range(2):
        _, _, _, dt_rep = run_eval_sweep(
            sweep, params, features, adj, nodes, labels_np, BATCH,
            NUM_NODES, generator())
        log(f"sweep repeat {rep + 1}: {dt_rep * 1e3:.2f} ms, "
            f"{NUM_NODES / dt_rep:.1f} nodes/s")

    # requests one at a time: one batch of 512 ids in, predictions back
    # on the host
    ids_all = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids_all[:NUM_NODES] = nodes
    ids_dev = torch.from_numpy(ids_all).to(dev)
    labels_table = torch.zeros(NUM_NODES + 1, NUM_CLASSES, device=dev)
    labels_table[:NUM_NODES] = torch.from_numpy(labels_np).to(dev)
    gen = generator()
    lat = []
    for i in range(n_b):
        t1 = time.perf_counter()
        _, p = sweep(params, features, adj,
                     ids_dev[i * BATCH:(i + 1) * BATCH], labels_table, gen)
        p.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"per request of {BATCH} nodes: p50 {np.percentile(lat, 50):.3f} ms, "
        f"p90 {np.percentile(lat, 90):.3f} ms, max {max(lat):.3f} ms")

    profile_window(
        lambda: sweep(params, features, adj, ids_dev[:20 * BATCH],
                      labels_table, gen),
        "one sweep of 20 batches")
    return launches


def profile_window(fn, label: str):
    """Device time by kernel over one call of ``fn``, and the device's
    busy share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if getattr(evt, "is_user_annotation", False):
            continue   # a range around kernels counted on their own
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            rows.append((dev_us, evt.count, evt.key))
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("profiler: no device time recorded (not measured)")
        return
    log(f"profiler, {label}: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / wall_us:.3f} of the window, profiler on)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")


# ------------------------------------------------------------ phase 5

def cli_predict(dev) -> None:
    """``python -m graphsage_tpu_torch predict`` on the card, checked
    against the CPU path on the same checkpoint (first_k sampling)."""
    import torch

    from graphsage_tpu_torch.data.io import load_data
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )
    from graphsage_tpu_torch.infer import predict
    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.train import checkpoint
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.supervised import build_supervised_config

    scratch = os.path.join(ROOT, "build")   # listed in .gitignore
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prefix = os.path.join(tmp, "toy", "toy")
        write_dataset(make_synthetic_graph(num_nodes=300, num_classes=5,
                                           feat_dim=32, seed=3), prefix)
        flags = TrainFlags(train_prefix=prefix, samples_1=5, samples_2=4,
                           dim_1=16, dim_2=16, max_degree=12, batch_size=64,
                           sampler_mode="first_k",
                           checkpoint_dir=os.path.join(tmp, "ckpt"))
        config = build_supervised_config(flags, load_data(prefix))
        checkpoint.save(flags.checkpoint_dir, init_supervised_params(
            torch.Generator().manual_seed(0), config), 1)
        out_dir = os.path.join(tmp, "preds")
        cmd = [sys.executable, "-m", "graphsage_tpu_torch", "predict",
               "--train_prefix", prefix, "--checkpoint_dir",
               flags.checkpoint_dir, "--samples_1", "5", "--samples_2", "4",
               "--dim_1", "16", "--dim_2", "16", "--max_degree", "12",
               "--batch_size", "64", "--sampler_mode", "first_k",
               "--nodes", "all", "--out_dir", out_dir,
               "--device", str(dev)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600, check=False)
        log(proc.stdout.strip())
        check(proc.returncode == 0,
              f"predict CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        for name in ("preds.npy", "nodes.txt"):
            check(os.path.exists(os.path.join(out_dir, name)),
                  f"predict CLI wrote no {name}")
        preds = np.load(os.path.join(out_dir, "preds.npy"))
        cpu = predict(flags, out_dir=os.path.join(tmp, "cpu"), nodes="all",
                      device="cpu")
        cpu_preds = np.load(os.path.join(cpu["out_dir"], "preds.npy"))
        diff = float(np.abs(preds - cpu_preds).max())
        log(f"predict CLI on {dev} vs CPU: preds {preds.shape}, max abs "
            f"diff {diff:.3e} (limit 1e-5)")
        check(preds.shape == (300, 5), f"preds shape {preds.shape}")
        check(diff <= 1e-5, f"card and CPU predictions differ by {diff}")


# ------------------------------------------------------------ phase 6

def train_full_width(dev, data) -> int:
    """bench.py's model with dropout 0.5 and Adam through the chunk
    runner; returns K2's launch count over the timed chunks."""
    import traceback
    import warnings

    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.ops.gather import fused_gather_mean
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    config = bench_config(True, DROPOUT)
    params = init_supervised_params(torch.Generator().manual_seed(0), config,
                                    device=dev)
    optimizer = make_optimizer(LEARNING_RATE)
    opt_state = optimizer.init(params)
    run = make_supervised_chunk_runner(config, optimizer, BATCH)
    n_b = -(-NUM_NODES // BATCH)
    host_rng = np.random.default_rng(4)
    ids_padded = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids_padded[:NUM_NODES] = np.arange(NUM_NODES)
    ids_perm = torch.from_numpy(
        ids_padded[host_rng.permutation(len(ids_padded))]).to(dev)
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    drop_seed = int(host_rng.integers(0, 2**63))
    step = 0

    def chunk(n):
        nonlocal params, opt_state, step
        params, opt_state, loss, logits, ids = run(
            params, opt_state, gen, features, adj, ids_perm, labels_table,
            step, n, drop_seed=drop_seed)
        step += n
        return loss, logits

    loss, _ = chunk(5)                       # warm-up
    check(np.isfinite(float(loss)), "non-finite loss in warm-up")

    fused_gather_mean.launches = 0
    fused_gather_mean.dropout_launches = 0
    times, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, logits = chunk(TRAIN_CHUNK)
        losses.append(float(loss))           # the print boundary
        times.append(time.perf_counter() - t0)
        check(np.isfinite(losses[-1]), f"non-finite loss {losses[-1]}")
    k1, k2 = fused_gather_mean.launches, fused_gather_mean.dropout_launches
    n_steps = 3 * TRAIN_CHUNK
    check(k2 == n_steps, f"K2 launched {k2} times in {n_steps} steps")
    check(k1 == 0, f"K1 launched {k1} times in training with dropout")
    check(logits.shape == (BATCH, NUM_CLASSES)
          and bool(torch.isfinite(logits).all()), "bad training logits")
    for i, (dt, lv) in enumerate(zip(times, losses)):
        log(f"train chunk {i + 1}: {TRAIN_CHUNK} steps in {dt * 1e3:.2f} ms,"
            f" {dt / TRAIN_CHUNK * 1e3:.4f} ms/step, "
            f"{EDGES_PER_STEP * TRAIN_CHUNK / dt:.1f} edges/s, loss "
            f"{lv:.5f}")
    log(f"training: K2 launches {k2} in {n_steps} steps (K1 {k1}); "
        f"{EDGES_PER_STEP} edges per step; losses {losses}")

    # host synchronisations inside a chunk, with the stack of each
    n_sync = 10
    stacks, notices = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        frames = traceback.extract_stack()[:-1]
        if any(f.name == "set_sync_debug_mode" for f in frames[-3:]):
            # raised by the call that switches the mode (line of
            # chip_smoke.py given), not by the chunk's work
            notices.append(f"{str(message).splitlines()[0][:100]!r} at the "
                           f"switch on line {frames[-3].lineno}")
        elif "synchroniz" in str(message):
            stacks.append(" <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in reversed(frames[-6:])))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            chunk(n_sync)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for st in stacks:
        where[st] = where.get(st, 0) + 1
    log(f"sync debug mode over {n_sync} steps: {len(stacks)} synchronising "
        f"calls, {len(stacks) / n_sync:.2f} per step"
        + "".join(f"\n  {n}x {st}" for st, n in sorted(where.items()))
        + "".join(f"\n  not counted: {m}" for m in notices))

    profile_window(lambda: chunk(5), "5 training steps")
    return k2


# ------------------------------------------------------------ phase 7

def fused_vs_unfused_training(dev, data) -> None:
    """4 steps at dropout 0 from the same weights and generator state,
    through K1 and through the plain gather: the same samples (the
    sampler's stream is shared), so the first step's gradients agree
    to f32 rounding (1e-5) and the params after 4 Adam steps to 1e-4,
    the tolerance of the CPU tests' Adam steps: Adam divides by
    |g| + eps, which amplifies last-bit gradient differences where |g|
    is near eps."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.ops.gather import fused_gather_mean
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    ids_perm = torch.from_numpy(np.random.default_rng(6).permutation(
        NUM_NODES)[:4 * BATCH].astype(np.int32)).to(dev)
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    out = {}
    for fused in (True, False):
        config = bench_config(fused)
        params = init_supervised_params(torch.Generator().manual_seed(7),
                                        config, device=dev)
        optimizer = make_optimizer(LEARNING_RATE)
        opt_state = optimizer.init(params)
        run = make_supervised_chunk_runner(config, optimizer, BATCH)
        gen = torch.Generator(device=dev).manual_seed(8)
        k1 = fused_gather_mean.launches
        losses = []
        for i in range(4):
            params, opt_state, loss, _, _ = run(
                params, opt_state, gen, features, adj, ids_perm,
                labels_table, i, 1)
            losses.append(float(loss))
            if i == 0:   # the clipped gradients of the first step
                grads = {k: p.grad.clone() for k, p in params.items()}
        out[fused] = (params, grads, losses,
                      fused_gather_mean.launches - k1)

    def max_diff(a, b):
        return max(float((a[k] - b[k]).detach().abs().max()) for k in a)

    g_diff = max_diff(out[True][1], out[False][1])
    p_diff = max_diff(out[True][0], out[False][0])
    l_diff = max(abs(a - b) for a, b in zip(out[True][2], out[False][2]))
    log(f"fused vs unfused training, 4 steps at dropout 0: first-step "
        f"grads max abs diff {g_diff:.3e} (limit 1e-5), losses {l_diff:.3e} "
        f"(limit 1e-5), params after 4 Adam steps {p_diff:.3e} (limit "
        f"1e-4); K1 launches {out[True][3]} vs {out[False][3]}")
    check(out[True][3] == 4 and out[False][3] == 0,
          "K1 did not run exactly on the fused side")
    check(g_diff <= 1e-5, f"fused and unfused gradients differ by {g_diff}")
    check(l_diff <= 1e-5, f"fused and unfused losses differ by {l_diff}")
    check(p_diff <= 1e-4, f"fused and unfused params differ by {p_diff}")


# ------------------------------------------------------------ phase 8

def cli_supervised(dev) -> None:
    """``python -m graphsage_tpu_torch supervised`` on the card against
    the same training on the CPU: first_k sampling and dropout 0 leave
    no random draw on the device, so the logged losses agree."""
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.supervised import train

    scratch = os.path.join(ROOT, "build")   # listed in .gitignore
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prefix = os.path.join(tmp, "toy", "toy")
        write_dataset(make_synthetic_graph(num_nodes=400, num_classes=5,
                                           feat_dim=32, seed=3), prefix)
        args = dict(samples_1=5, samples_2=4, dim_1=16, dim_2=16,
                    max_degree=12, batch_size=32, epochs=3, print_every=2,
                    validate_iter=3, validate_batch_size=16,
                    sampler_mode="first_k", dropout=0.0, seed=9)
        cmd = [sys.executable, "-m", "graphsage_tpu_torch", "supervised",
               "--train_prefix", prefix, "--base_log_dir",
               os.path.join(tmp, "card"), "--device", str(dev)]
        for k, v in args.items():
            cmd += [f"--{k}", str(v)]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600, check=False)
        log("\n".join(proc.stdout.strip().splitlines()[-6:]))
        check(proc.returncode == 0,
              f"supervised CLI exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        flags = TrainFlags(train_prefix=prefix,
                           base_log_dir=os.path.join(tmp, "cpu"), **args)
        with contextlib.redirect_stdout(io.StringIO()):
            train(flags, device="cpu")

        def logged(base):
            log_dir = os.path.join(base, "sup-toy",
                                   "graphsage_mean_small_0.0100")
            for name in ("val_stats.txt", "test_stats.txt"):
                check(os.path.exists(os.path.join(log_dir, name)),
                      f"no {name} in {log_dir}")
            with open(os.path.join(log_dir, "metrics.jsonl")) as fp:
                recs = [json.loads(line) for line in fp]
            return ([r["train_loss"] for r in recs if "train_loss" in r],
                    recs[-1]["final_val_loss"])

        card_losses, card_val = logged(os.path.join(tmp, "card"))
        cpu_losses, cpu_val = logged(os.path.join(tmp, "cpu"))
        check(len(card_losses) == len(cpu_losses) > 0,
              f"{len(card_losses)} vs {len(cpu_losses)} logged losses")
        diff = max(abs(a - b) for a, b in zip(card_losses + [card_val],
                                              cpu_losses + [cpu_val]))
        log(f"supervised CLI on {dev} vs CPU: {len(card_losses)} train "
            f"losses and the final val loss, max abs diff {diff:.3e} "
            f"(limit {CLI_TOL}); first/last train loss {card_losses[0]:.5f}"
            f"/{card_losses[-1]:.5f}, val {card_val:.5f}")
        check(diff <= CLI_TOL, f"card and CPU training differ by {diff}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from graphsage_tpu_torch.ops import build

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card_line = card()
    log(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[phase {name}: {time.perf_counter() - t0:.2f} s]")
        return result

    def build_kernels():
        _, nvcc_log = build.build("gather_mean")
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line or "registers" in line:
                log(f"  ptxas: {line.split(':', 1)[-1].strip()}")
        sass_summary()

    phase("build K1+K2 (gather_mean.cu)", build_kernels)
    k1 = phase("K1 vs plain", check_gather_mean, dev, card_line)
    k2 = phase("K2 vs plain", check_gather_mean_dropout, dev, card_line)
    data = phase("bench data", bench_data, dev)
    k1["launches"] = phase("serving", serve_full_width, dev, data)
    phase("predict CLI", cli_predict, dev)
    k2["launches"] = phase("training", train_full_width, dev, data)
    phase("fused vs unfused training", fused_vs_unfused_training, dev, data)
    phase("supervised CLI", cli_supervised, dev)
    log(f"chip_smoke total {time.perf_counter() - t_start:.2f} s")

    log(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
