#!/usr/bin/env python3
"""Drive the PyTorch port (graphsage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases; any failure exits non-zero without the final ok line:
  1. the card: nvidia-smi's name and power limit; TF32 off, as the
     parity tests' "highest" matmul precision
  2. build the CUDA kernels from the checkout's sources (nvcc)
  3. each kernel against its plain PyTorch version on the card, at the
     serving hop's shapes (f32 and bf16) and ragged ones; kernel, plain
     and library-call times beside the kernel's bound
  4. serving at full width, bench.py's model: 100k nodes, 602 features,
     41 classes, fanouts 25/10, dims 128/128, batch 512, zipf(1.05)
     adjacency, seeded random weights. The eval sweep answers every node
     (196 requests of 512); the gather-mean kernel must launch once per
     batch. Checks the predictions and their agreement with the unfused
     path, then times requests one by one and profiles one sweep
  5. ``python -m graphsage_tpu_torch predict`` on a small synthetic
     dataset from a port checkpoint, held against the CPU path
  6. one JSON line of per-kernel numbers, then the ok line (last)

Needs no network and one card; builds into build/kernels/.
"""

from __future__ import annotations

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
F32_TOL = 1e-5                         # max abs error, kernel vs plain
BF16_REL_TOL = 2e-2                    # max error / max |plain|
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


# ------------------------------------------------------------ phase 4

def serve_full_width(dev) -> int:
    """The eval sweep over all 100k nodes; returns K1's launch count."""
    import torch

    from graphsage_tpu_torch.infer import make_eval_sweep, run_eval_sweep
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
    from graphsage_tpu_torch.models.supervised import (
        SupervisedConfig,
        init_supervised_params,
    )
    from graphsage_tpu_torch.ops.gather import fused_gather_mean
    from graphsage_tpu_torch.train.metrics import calc_f1

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((NUM_NODES, FEAT_DIM)).astype(np.float32)
    adj_np = zipf_ids(rng, (NUM_NODES + 1, MAX_DEGREE))
    adj_np[NUM_NODES] = NUM_NODES   # the dummy node points at itself
    labels_np = np.eye(NUM_CLASSES, dtype=np.float32)[
        rng.integers(0, NUM_CLASSES, NUM_NODES)]
    features = torch.from_numpy(feats).to(dev)
    features = torch.cat([features, features.new_zeros(1, FEAT_DIM)])
    adj = torch.from_numpy(adj_np).to(dev)

    def config(fused: bool):
        sage = SAGEConfig(
            layers=(LayerInfo(FANOUTS[0], DIMS[0]),
                    LayerInfo(FANOUTS[1], DIMS[1])),
            feature_dim=FEAT_DIM, aggregator="mean", concat=True,
            num_nodes=NUM_NODES, sampler_mode="shared_perm",
            fused_gather=fused)
        return SupervisedConfig(sage=sage, num_classes=NUM_CLASSES)

    params = init_supervised_params(torch.Generator().manual_seed(0),
                                    config(True), device=dev)
    sweep = make_eval_sweep(config(True), BATCH, NUM_NODES)
    nodes = np.arange(NUM_NODES)
    n_b = -(-NUM_NODES // BATCH)
    torch.cuda.synchronize()
    log(f"serving set-up (data made on host, moved once): "
        f"{time.perf_counter() - t0:.2f} s")

    def generator():
        return torch.Generator(device=dev).manual_seed(1)

    run_eval_sweep(sweep, params, features, adj, nodes[:2 * BATCH],
                   labels_np, BATCH, NUM_NODES, generator())   # warm-up

    fused_gather_mean.launches = 0
    loss, preds, labels, dt = run_eval_sweep(
        sweep, params, features, adj, nodes, labels_np, BATCH, NUM_NODES,
        generator())
    launches = fused_gather_mean.launches

    log(f"served {NUM_NODES} nodes in {n_b} batches of {BATCH}: "
        f"{dt * 1e3:.2f} ms, {NUM_NODES / dt:.1f} nodes/s; gather_mean "
        f"launches {launches}")
    check(launches == n_b,
          f"gather_mean launched {launches} times for {n_b} batches")
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

    profile_sweep(sweep, params, features, adj, ids_dev[:20 * BATCH],
                  labels_table, gen)
    return launches


def profile_sweep(sweep, params, features, adj, ids, labels_table, gen):
    """Device time by kernel over one 20-batch sweep, and the device's
    busy share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(params, features, adj, ids, labels_table, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            rows.append((dev_us, evt.count, evt.key))
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("profiler: no device time recorded (not measured)")
        return
    log(f"profiler, one sweep of {ids.numel() // BATCH} batches: wall "
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
    from graphsage_tpu_torch.infer import build_supervised_config, predict
    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.train import checkpoint
    from graphsage_tpu_torch.train.config import TrainFlags

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from graphsage_tpu_torch.ops import build

    dev = torch.device("cuda:0")
    card_line = card()
    log(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _, nvcc_log = build.build("gather_mean")
    log(f"built gather_mean in {time.perf_counter() - t0:.2f} s")
    for line in nvcc_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"  ptxas: {line.split(':', 1)[-1].strip()}")

    kernels = [check_gather_mean(dev, card_line)]
    kernels[0]["launches"] = serve_full_width(dev)
    cli_predict(dev)

    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
