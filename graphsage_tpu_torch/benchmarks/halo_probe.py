"""The halo exchange's two schedules, ``overlap`` and ``blocking``, on D
graph ranks, the port of the JAX package's ``benchmarks/halo_probe.py``.

    python -m graphsage_tpu_torch.benchmarks.halo_probe --shards 2 \\
        --share_card                     # two gloo ranks on cuda:0
    python -m graphsage_tpu_torch.benchmarks.halo_probe --shards 4
                                         # four NCCL ranks, a card each
    python -m graphsage_tpu_torch.benchmarks.halo_probe --device cpu

The probe's own shape: 64,000 nodes, 128 features, a zipf(1.05)
adjacency of 32 neighbours, batch 512, fanouts 25/10, dims 128/128,
GraphSAGE-mean with the ``first_k`` sampler and no fused hop, so every
frontier's rows ride the exchange; tables and ids from
``default_rng(0)`` as the JAX script draws them, weights from torch
seed 0. Every rank embeds the whole batch, as the JAX script's
replicated ids do. For each schedule of
``parallel/graph_sharded.py::sharded_sage_embed``:
- ms a forward at capacity factor 4 (one warm-up, then ITERS forwards
  ended by a synchronisation);
- the ``all_to_all_single`` calls of one forward and the bytes they
  receive, counted at run time (``CountedAllToAll``; the JAX script
  reads both from the compiled HLO);
- the least capacity factor, in steps of 0.5, with which 4 batches from
  ``default_rng(7)`` drop no request (summed over the ranks).
Then the least such factor of the ``overlap`` schedule under the
``strided`` and the ``block`` row layouts.

D defaults to the JAX script's 8. The ranks start as the CLI starts
them (``parallel/launch.py::run_command``: NCCL, one card a rank, and a
host with fewer cards is refused), or, with ``--share_card``, as gloo
ranks all on ``cuda:0``, or as gloo ranks with ``--device cpu``. Prints
the card's name and power limit, then the JAX script's lines.
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
import torch.distributed as dist

from graphsage_tpu_torch.benchmarks import bench
from graphsage_tpu_torch.device import resolve_device

D = 8
NUM_NODES = 64_000
FEAT_DIM = 128
MAX_DEGREE = 32
BATCH = 512
FANOUTS = (25, 10)
ITERS = 10
TIMING_CAPACITY = 4.0
CAPACITIES = np.arange(0.5, 8.01, 0.5)
SCHEDULES = ("blocking", "overlap")
LAYOUTS = ("strided", "block")


class CountedAllToAll:
    """Within the block, ``torch.distributed.all_to_all_single`` counts
    its calls in ``calls`` and the bytes its outputs receive in
    ``nbytes`` (the exchange calls it through the module, so all of its
    calls are counted)."""

    def __enter__(self):
        self.calls, self.nbytes = 0, 0
        self._real = dist.all_to_all_single

        def counted(output, input, *args, **kwargs):
            self.calls += 1
            self.nbytes += output.numel() * output.element_size()
            return self._real(output, input, *args, **kwargs)

        dist.all_to_all_single = counted
        return self

    def __exit__(self, *exc):
        dist.all_to_all_single = self._real


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def workload() -> dict:
    """The module constants the ranks read (a spawned rank re-imports
    this module, so the caller's values travel as an argument)."""
    return {k: globals()[k] for k in ("NUM_NODES", "FEAT_DIM", "MAX_DEGREE",
                                      "BATCH", "FANOUTS", "ITERS")}


class Probe:
    """One rank's tables, weights and forward under one row layout."""

    def __init__(self, shape: dict, layout: str, grid, device):
        from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
        from graphsage_tpu_torch.models.supervised import (
            SupervisedConfig,
            init_supervised_params,
        )
        from graphsage_tpu_torch.parallel.graph_sharded import local_shard

        n, f = shape["NUM_NODES"], shape["FEAT_DIM"]
        s0, s1 = shape["FANOUTS"]
        self.shape, self.grid, self.device = shape, grid, device
        self.sage = SAGEConfig(
            layers=(LayerInfo(s0, 128), LayerInfo(s1, 128)), feature_dim=f,
            aggregator="mean", sampler_mode="first_k", num_nodes=n,
            shard_layout=layout)
        rng = np.random.default_rng(0)
        feats = np.vstack([rng.standard_normal((n, f)).astype(np.float32),
                           np.zeros((1, f), np.float32)])
        adj = bench.zipf_adjacency(rng, num_nodes=n,
                                   max_degree=shape["MAX_DEGREE"])
        self.params = init_supervised_params(
            torch.Generator().manual_seed(0),
            SupervisedConfig(sage=self.sage, num_classes=8), device=device)
        g, r = grid.graph_size, grid.graph_rank
        self.feat = torch.from_numpy(local_shard(feats, g, r, layout)).to(
            device)
        self.adj = torch.from_numpy(local_shard(adj, g, r, layout)).to(device)
        self.ids = self.batch(rng)

    def batch(self, rng) -> torch.Tensor:
        return torch.from_numpy(rng.integers(
            0, self.shape["NUM_NODES"], (self.shape["BATCH"],),
            dtype=np.int32)).to(self.device)

    @torch.no_grad()
    def forward(self, halo: str, capacity_factor: float, ids=None):
        """(embeddings, the dropped requests summed over the ranks)."""
        from graphsage_tpu_torch.parallel.graph_sharded import (
            sharded_sage_embed,
        )

        out, dropped = sharded_sage_embed(
            self.params, self.feat, self.adj,
            self.ids if ids is None else ids, self.sage,
            self.grid.graph_group, capacity_factor=capacity_factor,
            deterministic=True, return_stats=True, halo=halo)
        dist.all_reduce(dropped, group=self.grid.graph_group)
        return out, dropped

    def ms_per_forward(self, halo: str) -> float:
        self.forward(halo, TIMING_CAPACITY)
        _sync(self.device)
        dist.barrier(group=self.grid.graph_group)
        t0 = time.perf_counter()
        for _ in range(self.shape["ITERS"]):
            self.forward(halo, TIMING_CAPACITY)
        _sync(self.device)
        return (time.perf_counter() - t0) / self.shape["ITERS"] * 1e3

    def min_capacity_zero_drops(self, halo: str) -> float:
        """The least capacity factor (steps of 0.5) with which 4 batches
        from ``default_rng(7)`` drop nothing, as the JAX script finds it
        (first_k draws nothing, so the batches vary the frontier)."""
        for cap in CAPACITIES:
            rng = np.random.default_rng(7)
            total = 0
            for _ in range(4):
                _, d = self.forward(halo, float(cap), self.batch(rng))
                total += int(d)
            if total == 0:
                return float(cap)
        return float("inf")


def rank_main(device, n_shards: int, shape: dict, out_dir: str) -> None:
    """One rank: every measurement; rank 0 writes ``result.json``."""
    from graphsage_tpu_torch.parallel.distributed import make_grid

    grid = make_grid(n_shards, 1)
    result = {"schedules": {}, "min_capacity": {}}
    for layout in LAYOUTS:
        probe = Probe(shape, layout, grid, device)
        for halo in SCHEDULES:
            if layout == "strided":
                with CountedAllToAll() as counted:
                    probe.forward(halo, TIMING_CAPACITY)
                result["schedules"][halo] = {
                    "ms": probe.ms_per_forward(halo),
                    "all_to_all": counted.calls,
                    "bytes": counted.nbytes}
            result["min_capacity"][f"{halo}/{layout}"] = (
                probe.min_capacity_zero_drops(halo))
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as fp:
            json.dump(result, fp)


def probe(n_shards: int, device, share_card: bool = False) -> dict:
    """Run the ranks (``share_card``: gloo ranks all on the card
    ``device``) and return rank 0's result: per schedule its ms a
    forward, all-to-all calls and bytes; the least zero-drop capacity
    factor of each ``<schedule>/<layout>``."""
    from graphsage_tpu_torch.parallel import launch

    out_dir = tempfile.mkdtemp(prefix="halo_probe_")
    args = (rank_main, (n_shards, workload(), out_dir))
    try:
        if share_card:
            launch.spawn(*args, [device] * n_shards,
                         f"file://{out_dir}/store", backend="gloo")
        else:
            launch.run_command(*args, n_shards, 1, device=str(device))
        with open(os.path.join(out_dir, "result.json")) as fp:
            return json.load(fp)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def report(result: dict) -> list:
    """The JAX script's lines of a ``probe`` result."""
    lines, sched, caps = [], result["schedules"], result["min_capacity"]
    for halo in SCHEDULES:
        s = sched[halo]
        lines.append(
            f"{halo:9s}: {s['ms']:7.2f} ms/fwd   all-to-all ops: "
            f"{s['all_to_all']:3d}   operand MB: {s['bytes'] / 1e6:8.2f}   "
            f"min zero-drop capacity_factor: {caps[halo + '/strided']}")
    b_cap, o_cap = caps["blocking/strided"], caps["overlap/strided"]
    lines.append(
        f"overlap vs blocking: "
        f"{sched['blocking']['ms'] / sched['overlap']['ms']:.2f}x wall; "
        f"zero-drop exchange buffers {b_cap / o_cap:.1f}x smaller with "
        f"split-local")
    for layout in LAYOUTS:
        lines.append(f"layout={layout:7s}: min zero-drop capacity_factor "
                     f"{caps['overlap/' + layout]}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.halo_probe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--shards", type=int, default=D,
                   help=f"graph ranks (default {D})")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (gloo ranks)")
    p.add_argument("--share_card", action="store_true",
                   help="run every rank on cuda:0 over gloo")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    share = args.share_card and device.type == "cuda"
    print(f"# {bench.card_line(device)}; {args.shards} ranks "
          f"({f'gloo on {device}' if share else device.type})", flush=True)
    for line in report(probe(args.shards, device, share)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
