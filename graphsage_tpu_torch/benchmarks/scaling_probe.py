"""Multi-card scaling of the graph-sharded train step, the port of the
JAX package's ``benchmarks/scaling_probe.py``.

    python -m graphsage_tpu_torch.benchmarks.scaling_probe    # 1, 2, 4, ..
    python -m graphsage_tpu_torch.benchmarks.scaling_probe --devices 1,2,4
    python -m graphsage_tpu_torch.benchmarks.scaling_probe --devices 2 \\
        --data_shards 2                 # a 2 x 2 (data, graph) grid
    python -m graphsage_tpu_torch.benchmarks.scaling_probe --device cpu

bench.py's workload (100k nodes, 602 features, zipf(1.05) adjacency,
batch 512, fanouts 25/10, dims 128/128, GraphSAGE-mean with the fused
inner hop: the gather-mean kernel K1 at one graph shard, the split
local/remote mean at more) through
``parallel/graph_sharded.py::make_sharded_supervised_chunk_runner`` on D
graph ranks, or on M x D ranks with ``--data_shards M``. The ranks start
as the CLI starts them (``parallel/launch.py::run_command``): one process
a rank, NCCL with rank r on ``cuda:r``, or gloo ranks with ``--device
cpu`` (the counterpart of the JAX script's ``--cpu`` and its 8 virtual
devices: the default sizes there go up to 8). Every rank draws the
tables, labels and ids from ``default_rng(0)`` in the JAX script's
order and keeps its shard; the exchange's capacity factor comes from
``suggest_capacity_factor``. Timing: 2 warm-up chunks of CHUNK steps,
then 3 timed chunks ended by reading the loss (the world's sum).

One JSON line a size, with the JAX script's keys (``platform`` is the
card's name, or ``cpu``), the card's name and power limit, the dropped
requests and each rank's kernel launches over the timed chunks. The JAX
script skips the sizes above its device count; this one refuses them,
naming how many cards it found.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import bench
from graphsage_tpu_torch.device import resolve_device

WARMUP_CHUNKS = 2
CHUNK = 20
TIMED_CHUNKS = 3
CPU_DEVICES = 8   # the JAX script's --cpu mesh


def edges_per_step() -> int:
    return bench.BATCH * (bench.FANOUTS[1] + bench.FANOUTS[1]
                          * bench.FANOUTS[0])


def workload() -> dict:
    """The module constants the ranks read (a spawned rank re-imports the
    modules, so the caller's values travel as an argument)."""
    names = ("NUM_NODES", "FEAT_DIM", "NUM_CLASSES", "MAX_DEGREE", "BATCH",
             "FANOUTS", "DIMS", "LEARNING_RATE")
    shape = {k: getattr(bench, k) for k in names}
    shape.update(WARMUP_CHUNKS=WARMUP_CHUNKS, CHUNK=CHUNK,
                 TIMED_CHUNKS=TIMED_CHUNKS)
    return shape


def rank_main(device, graph_shards: int, data_shards: int, shape: dict,
              out_dir: str) -> None:
    """One rank of a ``graph_shards x data_shards`` run: times the sharded
    chunk runner and writes ``rank<r>.json`` in ``out_dir`` (edges/s,
    the capacity factor, dropped requests, this rank's launches)."""
    import torch.distributed as dist

    from graphsage_tpu_torch.models.supervised import (
        SupervisedConfig,
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.distributed import fold_seed, make_grid
    from graphsage_tpu_torch.parallel.graph_sharded import (
        local_shard,
        make_sharded_supervised_chunk_runner,
        suggest_capacity_factor,
    )
    from graphsage_tpu_torch.parallel.launch import gather_launches

    for k, v in shape.items():
        if hasattr(bench, k):
            setattr(bench, k, v)
    N, C, B = shape["NUM_NODES"], shape["NUM_CLASSES"], shape["BATCH"]
    D = graph_shards
    grid = make_grid(D, data_shards)
    sup = SupervisedConfig(sage=bench.sage_config(True), num_classes=C,
                           sigmoid_loss=False, weight_decay=0.0)
    layout = sup.sage.shard_layout
    rng = np.random.default_rng(0)
    feats = bench.feature_table(rng)
    adj = bench.zipf_adjacency(rng)
    labels_table = np.zeros((N + 1, C), np.float32)
    labels_table[np.arange(N), rng.integers(0, C, N)] = 1.0
    cap = suggest_capacity_factor(adj, D, layout=layout)
    feat_local = torch.from_numpy(local_shard(
        feats, D, grid.graph_rank, layout)).to(device)
    adj_local = torch.from_numpy(local_shard(
        adj, D, grid.graph_rank, layout)).to(device)
    del feats, adj
    params = init_supervised_params(torch.Generator().manual_seed(0), sup,
                                    device=device)
    optimizer = make_optimizer(shape["LEARNING_RATE"])
    opt_state = optimizer.init(params)
    runner = make_sharded_supervised_chunk_runner(
        sup, optimizer, grid, B, capacity_factor=cap)
    chunk_steps = shape["CHUNK"]
    n_steps = (shape["WARMUP_CHUNKS"] + shape["TIMED_CHUNKS"]) * chunk_steps
    ids_perm = torch.from_numpy(rng.integers(
        0, N, (n_steps * B,), dtype=np.int32)).to(device)
    labels_dev = torch.from_numpy(labels_table).to(device)
    gen = torch.Generator(device=device).manual_seed(fold_seed(7, grid.me))
    start, dropped = 0, 0

    def chunk():
        nonlocal params, opt_state, start
        params, opt_state, loss, _, _, d = runner(
            params, opt_state, gen, feat_local, adj_local, ids_perm,
            labels_dev, start, chunk_steps, drop_seed=7)
        start += chunk_steps
        return loss, d

    for _ in range(shape["WARMUP_CHUNKS"]):
        loss, d = chunk()
    float(loss)          # the barrier: warm-up done on every rank
    dropped += int(d)
    before = gather_launches()
    t0 = time.perf_counter()
    for _ in range(shape["TIMED_CHUNKS"]):
        loss, d = chunk()
    loss = float(loss)   # the barrier ends the timing
    dt = (time.perf_counter() - t0) / (shape["TIMED_CHUNKS"] * chunk_steps)
    dropped += int(d)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    after = gather_launches()
    out = {"edges_per_sec": edges_per_step() / dt, "sec_per_step": dt,
           "loss": loss, "capacity_factor": cap, "dropped": dropped,
           "launches": {k: after[k] - before[k] for k in after}}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"),
              "w") as fp:
        json.dump(out, fp)


def run_at(D: int, data_shards: int, device) -> list:
    """Each rank's ``rank_main`` result of one ``data_shards x D`` run,
    in rank order."""
    from graphsage_tpu_torch.parallel import launch

    out_dir = tempfile.mkdtemp(prefix="scaling_probe_")
    try:
        launch.run_command(rank_main, (D, data_shards, workload(), out_dir),
                           D, data_shards, device=str(device))
        results = []
        for r in range(D * data_shards):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fp:
                results.append(json.load(fp))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def available(device) -> int:
    return CPU_DEVICES if device.type == "cpu" else torch.cuda.device_count()


def measure(sizes, data_shards: int, device) -> list:
    """One row a size (JAX's keys and the port's), after refusing any
    size whose ranks need more devices than there are."""
    avail = available(device)
    too_big = [D for D in sizes if D * data_shards > avail]
    if too_big:
        what = ("CPU ranks it runs" if device.type == "cpu"
                else "CUDA devices it found")
        raise RuntimeError(
            f"sizes {too_big} x --data_shards {data_shards} need more ranks "
            f"than the {avail} {what}")
    platform = ("cpu" if device.type == "cpu"
                else torch.cuda.get_device_name(device))
    line = bench.card_line(device)
    base, rows = None, []
    for D in sizes:
        ranks = run_at(D, data_shards, device)
        eps = ranks[0]["edges_per_sec"]
        base = base if base is not None else (D, eps)
        rows.append({
            "metric": "sharded_train_edges_per_sec",
            "devices": D,
            "data_shards": data_shards,
            "platform": platform,
            "value": round(eps),
            "unit": "edges/s",
            "scaling_efficiency_vs_smallest": round(
                eps / (base[1] * D / base[0]), 4),
            "icinote": (None if device.type != "cpu" else
                        "gloo ranks on the CPU: correctness only, not "
                        "NVLink"),
            "card": line,
            "sec_per_step": ranks[0]["sec_per_step"],
            "capacity_factor": ranks[0]["capacity_factor"],
            "dropped": sum(r["dropped"] for r in ranks),
            "launches": [r["launches"] for r in ranks],
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.scaling_probe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", default=None,
                   help="comma-separated graph shard counts (default: every "
                   "power of 2 that fits)")
    p.add_argument("--data_shards", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: NCCL, one card a rank) or cpu "
                   "(gloo ranks)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.devices:
        sizes = [int(x) for x in args.devices.split(",")]
    else:
        sizes, d = [], 1
        while d * args.data_shards <= available(device):
            sizes.append(d)
            d *= 2
    print(f"# platform={device.type} devices={available(device)} "
          f"sizes={sizes}", file=sys.stderr, flush=True)
    measure(sizes, args.data_shards, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
