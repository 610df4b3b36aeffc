"""Headline benchmark: supervised GraphSAGE-mean train-step throughput on
the card, the port of the JAX package's root ``bench.py``.

    python -m graphsage_tpu_torch.benchmarks.bench [--dist uniform]
        [--headline-only] [--device cpu]

The workload is bench.py's: a Reddit-shaped graph of 100k nodes with
602 features, 41 classes and a zipf(1.05) adjacency of 128 neighbours
over degree-ordered ids (``--dist uniform``: uniform ids), batch 512,
fanouts 25/10, dims 128/128, softmax head, Adam at lr 1e-2, the
``shared_perm`` sampler, the fused gather-mean (K1) for the innermost
hop. The feature table, labels and ids come from ``default_rng(0)`` in
bench.py's order (``build``); the weights from torch seed 0, so they are
the port's own draw. The features stay 602 wide: the port has no
128-lane padding.

The metric is sampled edges aggregated per second, batch * (S2 +
S2*S1) a step (bench.py:378). The headline runs the trainers' chunk
runner (``parallel/dp.py::make_supervised_chunk_runner``): 2 warm-up
chunks and the best of 3 timed chunks of ITERS steps, each ended by
reading the loss. ``sec_per_step_dispatch`` is one training step a call
(best of 3 trials of ITERS steps). ``roofline_frac`` divides bench.py's
bytes a step (the feature rows of the pyramid, at the port's table
width, and the adjacency rows) by the H100's 3.35 TB/s. ``vs_baseline``,
``vs_reenactment`` and ``baseline_provenance`` read the reference
code's measured CPU rate from ``benchmarks/BASELINE_MEASURED.json``;
the script raises where the JAX one would fall back to an estimate.
``secondary`` holds six of agg_sweep's configs and the embed sweep
(bench.py's ``measure_secondaries``), within its deadline.

Dropped from the JAX script: ``wall_frac``, which divides by the TPU's
row-DMA issue wall and has no Hopper meaning; the TPU preflight, its
failure payload and ``BENCH_LAST.json``. A failure raises, in the
secondaries too (the JAX script records it as a string). Every line
carries the card's name and power limit (``card``).

Prints exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from graphsage_tpu_torch.device import resolve_device

NUM_NODES = 100_000
FEAT_DIM = 602
NUM_CLASSES = 41
MAX_DEGREE = 128
BATCH = 512
FANOUTS = (25, 10)
DIMS = (128, 128)
WARMUP = 5
ITERS = 100
LEARNING_RATE = 1e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
SECONDARY_DEADLINE_S = 480.0
SECONDARY_CONFIGS = ("gcn", "identity64", "mean_uniform", "unsup_mean",
                     "meanpool_fused", "mean_drop")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE_PATH = os.path.join(ROOT, "benchmarks", "BASELINE_MEASURED.json")


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (``cpu`` on the
    CPU), to stand beside every number."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def zipf_adjacency(rng, alpha: float = 1.05, num_nodes: int | None = None,
                   max_degree: int | None = None) -> np.ndarray:
    """[N+1, max_degree] int32 neighbour ids drawn zipf over degree-ordered
    ids: id 0 is the biggest hub (bench.py:66-73; N and max_degree this
    module's unless given)."""
    n = NUM_NODES if num_nodes is None else num_nodes
    degree = MAX_DEGREE if max_degree is None else max_degree
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    flat = rng.choice(n, size=(n + 1) * degree, p=p)
    return flat.reshape(n + 1, degree).astype(np.int32)


def feature_table(rng) -> np.ndarray:
    """[N+1, F] f32 standard normals with the zero dummy row."""
    return np.vstack([
        rng.standard_normal((NUM_NODES, FEAT_DIM)).astype(np.float32),
        np.zeros((1, FEAT_DIM), dtype=np.float32)])


def sage_config(fused: bool = True, aggregator: str = "mean", **kw):
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig

    return SAGEConfig(
        layers=(LayerInfo(FANOUTS[0], DIMS[0]),
                LayerInfo(FANOUTS[1], DIMS[1])),
        feature_dim=FEAT_DIM, aggregator=aggregator, concat=True,
        fused_gather=fused, num_nodes=NUM_NODES, **kw)


def build(fused: bool = True, dist: str = "zipf", device="cpu") -> dict:
    """bench.py's ``build``: the model, one training step, and the
    tables, labels, mask and ids drawn from ``default_rng(0)`` in its
    order, on ``device``."""
    from graphsage_tpu_torch.models.supervised import (
        SupervisedConfig,
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.dp import make_supervised_train_step

    config = SupervisedConfig(sage=sage_config(fused),
                              num_classes=NUM_CLASSES, sigmoid_loss=False,
                              weight_decay=0.0)
    rng = np.random.default_rng(0)
    features = feature_table(rng)
    if dist == "zipf":
        adj = zipf_adjacency(rng)
    else:
        adj = rng.integers(0, NUM_NODES, (NUM_NODES + 1, MAX_DEGREE),
                           dtype=np.int32)
    labels_idx = rng.integers(0, NUM_CLASSES, (BATCH,))
    labels = np.eye(NUM_CLASSES, dtype=np.float32)[labels_idx]
    ids = rng.integers(0, NUM_NODES, (BATCH,), dtype=np.int32)
    params = init_supervised_params(torch.Generator().manual_seed(0), config,
                                    device=device)
    optimizer = make_optimizer(LEARNING_RATE)
    return {"step": make_supervised_train_step(config, optimizer),
            "params": params, "opt_state": optimizer.init(params),
            "features": torch.from_numpy(features).to(device),
            "adj": torch.from_numpy(adj).to(device),
            "ids": torch.from_numpy(ids).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "mask": torch.ones(BATCH, device=device), "config": config}


def measured_baseline(path: str = BASELINE_PATH):
    """(reference rate, provenance, re-enactment rate or None): the
    reference code's measured CPU rate, read as data (bench.py:137-160).
    Raises where the file is missing or lacks the rate."""
    with open(path) as fp:
        data = json.load(fp)
    reenact = data.get("reenactment_edges_per_sec")
    return (float(data["reference_edges_per_sec"]),
            data.get("provenance", "measured, see " + path),
            float(reenact) if reenact else None)


def measure_secondaries(device, deadline_s: float = 1e9) -> dict:
    """bench.py's ``measure_secondaries``: six of agg_sweep's configs in
    the chunked mode (edges/s) and the embed sweep over every node
    (nodes/s, best of 2 after a warm-up); past ``deadline_s`` the rest
    are recorded as skipped."""
    from graphsage_tpu_torch.benchmarks import agg_sweep
    from graphsage_tpu_torch.models.unsupervised import (
        UnsupervisedConfig,
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.train.unsupervised import make_embed_sweep

    out = {}
    t0 = time.perf_counter()
    for name in SECONDARY_CONFIGS:
        if time.perf_counter() - t0 > deadline_s:
            out[name + "_skipped"] = "time budget exhausted"
            continue
        agg, size, fused, sdist, idd, unsup, *extra = agg_sweep.CONFIGS[name]
        fn = (agg_sweep.run_unsupervised if unsup
              else agg_sweep.run_supervised)
        sec, edges = fn(name, agg, size, fused, sdist, idd,
                        extra[0] if extra else 0.0, device=device)
        out[name + "_edges_per_sec"] = round(edges / sec, 1)
    if time.perf_counter() - t0 > deadline_s:
        out["serving_skipped"] = "time budget exhausted"
        return out
    rng = np.random.default_rng(0)
    features = torch.from_numpy(feature_table(rng)).to(device)
    adj = torch.from_numpy(zipf_adjacency(rng)).to(device)
    ids_all = padded_node_stream(device)
    uconf = UnsupervisedConfig(sage=sage_config(True))
    uparams = init_unsupervised_params(torch.Generator().manual_seed(0),
                                       uconf, device=device)
    sweep = make_embed_sweep(uconf, BATCH)

    def run():
        rows = sweep(uparams, features, adj, ids_all,
                     torch.Generator(device=device).manual_seed(7))
        float(rows[0, 0])

    run()
    best = float("inf")
    for _ in range(2):
        t_trial = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t_trial)
    out["serving_embed_nodes_per_sec"] = round(ids_all.shape[0] / best, 1)
    return out


def padded_node_stream(device) -> torch.Tensor:
    """Every node id, dummy-padded to whole batches (infer.py's stream)."""
    n_b = -(-NUM_NODES // BATCH)
    ids = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids[:NUM_NODES] = np.arange(NUM_NODES)
    return torch.from_numpy(ids).to(device)


def headline(dist: str, device) -> dict:
    """The dispatch-mode and chunked-mode sections of bench.py's
    ``main``: (sec_per_step, sec_per_step_dispatch, the feature table's
    row bytes)."""
    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner

    b = build(dist=dist, device=device)
    params, opt_state = b["params"], b["opt_state"]
    gen = torch.Generator(device=device).manual_seed(1)

    def steps(n):
        nonlocal params, opt_state
        for _ in range(n):
            params, opt_state, loss, _ = b["step"](
                params, opt_state, gen, b["features"], b["adj"], b["ids"],
                b["labels"], b["mask"])
        return float(loss)   # the completion barrier

    steps(WARMUP)
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        steps(ITERS)
        best_dt = min(best_dt, time.perf_counter() - t0)
    sec_per_step_dispatch = best_dt / ITERS
    del params, opt_state

    config = b["config"]
    rng_np = np.random.default_rng(3)
    cparams = init_supervised_params(torch.Generator().manual_seed(0),
                                     config, device=device)
    optimizer = make_optimizer(LEARNING_RATE)
    copt = optimizer.init(cparams)
    runner = make_supervised_chunk_runner(config, optimizer, BATCH)
    labels_table = np.zeros((NUM_NODES + 1, NUM_CLASSES), np.float32)
    labels_table[np.arange(NUM_NODES),
                 rng_np.integers(0, NUM_CLASSES, NUM_NODES)] = 1.0
    labels_dev = torch.from_numpy(labels_table).to(device)
    n_total = (2 + 3) * ITERS   # 2 warm-up + 3 timed chunks
    ids_perm = torch.from_numpy(rng_np.integers(
        0, NUM_NODES, (n_total * BATCH,), dtype=np.int32)).to(device)
    cgen = torch.Generator(device=device).manual_seed(11)
    start = 0

    def chunk():
        nonlocal cparams, copt, start
        cparams, copt, loss, *_ = runner(
            cparams, copt, cgen, b["features"], b["adj"], ids_perm,
            labels_dev, start, ITERS, drop_seed=11)
        start += ITERS
        return float(loss)

    for _ in range(2):
        chunk()
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        loss = chunk()
        best_dt = min(best_dt, time.perf_counter() - t0)
        assert np.isfinite(loss), f"non-finite loss {loss}"
    features = b["features"]
    return {"sec_per_step": best_dt / ITERS,
            "sec_per_step_dispatch": sec_per_step_dispatch,
            "row_bytes": features.shape[1] * features.element_size()}


def main(argv=None) -> int:
    t_main0 = time.perf_counter()
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--dist", choices=("zipf", "uniform"), default="zipf")
    p.add_argument("--headline-only", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ref_rate, provenance, reenact_rate = measured_baseline()
    h = headline(args.dist, device)
    sec_per_step = h["sec_per_step"]
    edges_per_step = BATCH * (FANOUTS[1] + FANOUTS[1] * FANOUTS[0])
    edges_per_sec = edges_per_step / sec_per_step
    # bench.py:384-388: the pyramid's feature rows and the adjacency rows
    rows = BATCH * (1 + FANOUTS[1] + FANOUTS[1] * FANOUTS[0])
    bytes_per_step = (rows * h["row_bytes"]
                      + BATCH * (1 + FANOUTS[1]) * MAX_DEGREE * 4)
    result = {
        "metric": "supervised_train_edges_per_sec",
        "value": round(edges_per_sec, 1),
        "unit": "edges/s/chip",
        "vs_baseline": round(edges_per_sec / ref_rate, 3),
        "baseline_provenance": provenance,
        "baseline_edges_per_sec": ref_rate,
        **({"vs_reenactment": round(edges_per_sec / reenact_rate, 3)}
           if reenact_rate else {}),
        "graph_dist": args.dist,
        "sec_per_step": round(sec_per_step, 6),
        "sec_per_step_dispatch": round(h["sec_per_step_dispatch"], 6),
        "roofline_frac": round(
            bytes_per_step / sec_per_step / HBM_BYTES_PER_S, 4),
        "card": card_line(device),
    }
    if not args.headline_only:
        result["secondary"] = measure_secondaries(
            device, SECONDARY_DEADLINE_S - (time.perf_counter() - t_main0))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
