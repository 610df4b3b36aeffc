"""Probe: gather-mean designs at the Reddit inner-hop chunk (B = 1024
output rows, S = 25 samples, F = 640, N = 100k, zipf(1.05) ids), the
port of the JAX package's ``benchmarks/gather_probe.py`` to Hopper.

    python -m graphsage_tpu_torch.benchmarks.gather_probe --dist zipf \\
        --variants k1,plain,bulkwait,tilewait,hot1024,hotmx1024,hc1024

Variants (ops/gather_probe.py holds the kernels):
  xla_f32 / xla_bf16 — index_select + mean (the library route)
  xla_sorted         — the same on each row's ids sorted
  k1                 — the port's production gather-mean (ops/gather.py, K1)
  plain              — K7a: bulk row copies, one mbarrier wait per sample
  bulkwait           — K7a: one wait per output row
  tilewait           — K7a: one wait per tile
  plain_sorted       — plain on each row's ids sorted
  <wait>_t<r>b<n>    — plain, bulkwait or tilewait with stages of r rows
                       and n ring stages
  hot<K>             — K7a: ids < K read from the table (L2 evict-last)
  hotmx<K>[t<r>]     — K7c: counts @ hot rows (2xTF32 tensor cores) + the
                       cold rows, from the raw ids; tiles of r rows (80)
  coldsw<K>          — K7a: the compacted cold rows only (timing only)
  hotcount<K>        — K7b: counts @ the bf16 hot block only (timing only)
  hc<K>              — coldsw + hotcount, summed outside
  prep               — the top_k compaction of coldsw/hc alone
  <kind>_bf16        — <kind> on a bf16 table

Timing: INNER gathers in a row, best of 3 trials of ITERS, by CUDA events
with the calls queued behind a spin kernel that outlasts their queueing
(so the host does not set the pace); on the CPU (``--device cpu``, the
plain versions) by the host clock. Each line gives ms per gather,
Mrow/s (B x S sampled rows a gather) and, on a card, the share of the
least time the card needs for the same work (``bound_ms``). The kinds
that compact their ids (coldsw, hc) are timed with the compaction, as
the JAX probe times them; hotmx needs none. Exits non-zero if any
variant failed.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.ops.gather import fused_gather_mean
from graphsage_tpu_torch.ops.gather_probe import (
    MX_TILE_B,
    RING_STAGES,
    cold_first_topk,
    probe_coldsw,
    probe_gather,
    probe_gather_hot,
    probe_hotcount,
    probe_hotmx,
)

N = 100_000
F = 640
B = 1024  # per-chunk rows (the production kernel chunked at 1024)
S = 25
ITERS = 5
INNER = 20  # gathers a trial, queued back to back

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
SPIN_CYCLES_PER_S = 2e9     # ~the H100's SM clock (1.98 GHz boost)
MIN_SPIN_CYCLES = 60_000_000  # ~30 ms: the queue's least head start


def make_ids(dist: str, rng: np.random.Generator, n_steps: int):
    """[n_steps, B, S] int32 sample ids. zipf ~ degree-sorted power law."""
    if dist == "uniform":
        return rng.integers(0, N, (n_steps, B, S), dtype=np.int32)
    # zipf over ranks 1..N (alpha ~1.05): node id = rank - 1 (table is
    # degree-ordered so hot nodes have small ids)
    alpha = 1.05
    ranks = np.arange(1, N + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    flat = rng.choice(N, size=n_steps * B * S, p=p).astype(np.int32)
    return flat.reshape(n_steps, B, S)


def make_table(rng: np.random.Generator) -> np.ndarray:
    """[N+1, F] f32: standard normal rows and the zero dummy row N."""
    return np.vstack([rng.standard_normal((N, F)).astype(np.float32),
                      np.zeros((1, F), np.float32)])


def xla_gather_mean(features: torch.Tensor, idx: torch.Tensor):
    """The library route: index_select, then the f32 mean over S."""
    rows = features.index_select(0, idx.reshape(-1))
    return rows.view(*idx.shape, features.shape[1]).float().mean(dim=1)


def build_call(kind: str, dt: torch.dtype, n_buf: int = RING_STAGES,
               tile_b: int | None = None, K: int = 1024):
    """fn(idx, table[, hot block]) of one probe kind on a table of ``dt``,
    as the JAX ``build_call``; the hot kinds read their hot rows from the
    table itself, and hotcount/hc take the bf16 hot block. tile_b
    defaults to K7a's ``ring_rows`` (None) and to hotmx's ``MX_TILE_B``."""
    if tile_b is None and kind == "hotmx":
        tile_b = MX_TILE_B

    def table_of(table):
        if table.dtype != dt:
            raise TypeError(f"{kind} built for {dt}, given {table.dtype}")
        return table

    if kind in ("plain", "bulkwait", "tilewait"):
        wait = {"plain": "sample", "bulkwait": "row", "tilewait": "tile"}[kind]
        return lambda idx, table: probe_gather(table_of(table), idx, wait,
                                               tile_b, n_buf)
    if kind == "hot":
        return lambda idx, table: probe_gather_hot(table_of(table), idx, K,
                                                   tile_b, n_buf)
    if kind == "hotmx":
        return lambda idx, table: probe_hotmx(table_of(table), idx, K,
                                              tile_b)
    if kind in ("coldsw", "hc"):
        def cold(idx, table):
            table = table_of(table)
            idx_dma, nb, _ = cold_first_topk(idx, K, table.shape[0] - 1)
            return probe_coldsw(table, idx_dma, nb, idx.shape[1], tile_b,
                                n_buf)

        if kind == "coldsw":
            return cold
        return lambda idx, table, hot: cold(idx, table) + probe_hotcount(
            idx, hot)
    if kind == "hotcount":
        return lambda idx, hot: probe_hotcount(idx, hot)
    if kind == "prep":
        return lambda idx, table: cold_first_topk(idx, K,
                                                  table.shape[0] - 1)[0]
    if kind == "k1":
        return lambda idx, table: fused_gather_mean(table_of(table), idx)
    raise ValueError(kind)


def bench(fn, idx_steps, args_fn, ref_out=None) -> float:
    """Seconds per gather: INNER calls in a row, cycling over idx_steps,
    best of 3 trials of ITERS. The INNER-th call runs on
    idx_steps[(INNER - 1) % len]: ref_out (computed on that set) checks
    its result (the JAX probe's 5e-2)."""
    cuda = idx_steps.device.type == "cuda"

    def many():
        for i in range(INNER):
            out = fn(idx_steps[i % idx_steps.shape[0]], *args_fn())
        return out

    out = many()
    if ref_out is not None:
        err = float((out - ref_out).abs().max())
        if not err < 5e-2:
            raise RuntimeError(f"mismatch: {err}")
    if cuda:
        # the spin outlasts twice the host's time to queue a trial, so
        # that a kind of many small launches (the compactions) is timed
        # on the device and not at the host's pace
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many()
        queue_s = time.perf_counter() - t0
        spin = max(MIN_SPIN_CYCLES,
                   int(2 * ITERS * queue_s * SPIN_CYCLES_PER_S))
    best = float("inf")
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(ITERS):
                many()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                many()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / (ITERS * INNER)


def bound_ms(kind: str, idx_steps: torch.Tensor, elem: int, K: int):
    """(ms, "bytes" or "operations"): the least time an H100 needs for one
    gather of ``kind``, the larger of its bytes over the memory rate
    (each distinct row it reads once, the f32 output, the ids; the hot
    block for hotcount/hc) and its operations over the f32 peak rate
    (the function's B x S x F adds, whatever the design: the counts
    kernels' dense products do more work than the mean needs), averaged
    over the id sets."""
    _, n_out, n_samples = idx_steps.shape
    bytes_ms, ops_ms = [], []
    for ids in idx_steps:
        rows = torch.unique(ids)
        if kind in ("coldsw", "hc", "hotcount"):
            rows = rows[rows >= K]
        n_bytes = n_out * F * 4 + n_out * n_samples * 4
        if kind != "hotcount":
            n_bytes += rows.numel() * F * elem
        if kind in ("hotcount", "hc"):
            n_bytes += K * F * 2
        ops = n_out * n_samples * F / F32_OPS_PER_S
        bytes_ms.append(n_bytes / HBM_BYTES_PER_S * 1e3)
        ops_ms.append(ops * 1e3)
    b, o = float(np.mean(bytes_ms)), float(np.mean(ops_ms))
    return (b, "bytes") if b >= o else (o, "operations")


def parse_variant(v: str, tables: dict, hot_bf16: torch.Tensor):
    """(fn, its extra args, timing only, kind, K) of one variant name;
    ``<kind>_bf16`` runs <kind> on the bf16 table."""
    dt = torch.float32
    if v.endswith("_bf16"):
        v, dt = v[:-5], torch.bfloat16
    table = tables[dt]

    def on_table():
        return (table,)

    if v in ("xla", "xla_f32"):
        return (lambda idx, t: xla_gather_mean(t, idx), on_table,
                v == "xla_f32", "xla", 0)
    if v == "xla_sorted":
        return (lambda idx, t: xla_gather_mean(
            t, torch.sort(idx, dim=1).values), on_table, False, "xla", 0)
    if v == "plain_sorted":
        base = build_call("plain", dt)
        return (lambda idx, t: base(torch.sort(idx, dim=1).values, t),
                on_table, False, "plain", 0)
    if "_t" in v:  # <wait>_t<r>b<n>: stage rows, stages
        kind, ring = v.split("_t")
        tb, nb = ring.split("b")
        return (build_call(kind, dt, tile_b=int(tb), n_buf=int(nb)),
                on_table, False, kind, 0)
    if v.startswith("hc"):
        K = int(v[2:])
        return (build_call("hc", dt, K=K),
                lambda hb=hot_bf16[:K]: (table, hb), False, "hc", K)
    if v.startswith("coldsw"):
        K = int(v[6:])
        return build_call("coldsw", dt, K=K), on_table, True, "coldsw", K
    if v.startswith("hotcount"):
        K = int(v[8:])
        return (build_call("hotcount", dt, K=K),
                lambda hb=hot_bf16[:K]: (hb,), True, "hotcount", K)
    if v == "prep":
        return build_call("prep", dt, K=2048), on_table, True, "prep", 2048
    if v.startswith("hotmx"):
        parts = v[5:].split("t")
        K = int(parts[0])
        tb = int(parts[1]) if len(parts) > 1 else MX_TILE_B
        return (build_call("hotmx", dt, K=K, tile_b=tb), on_table, False,
                "hotmx", K)
    if v.startswith("hot"):
        K = int(v[3:])
        return build_call("hot", dt, K=K), on_table, False, "hot", K
    return build_call(v, dt), on_table, False, v, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist", default="zipf", choices=("zipf", "uniform"))
    ap.add_argument("--variants", default=(
        "xla_f32,xla_bf16,k1,plain,bulkwait,tilewait,hot1024,hot4096"
    ))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(make_table(rng)).to(dev)
    tables = {torch.float32: feats, torch.bfloat16: feats.to(torch.bfloat16)}
    hot_bf16 = tables[torch.bfloat16]
    ids_np = make_ids(args.dist, rng, 4)
    ids = torch.from_numpy(ids_np).to(dev)
    frac_hot1k = float((ids_np < 1024).mean())
    frac_hot4k = float((ids_np < 4096).mean())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# dist={args.dist} B={B} S={S} F={F} N={N} "
          f"hot-coverage: K=1024 {frac_hot1k:.2f}, K=4096 {frac_hot4k:.2f} "
          f"on {name}", flush=True)

    ref_out = xla_gather_mean(feats, ids[(INNER - 1) % ids.shape[0]])
    failed = []
    for v in args.variants.split(","):
        v = v.strip()
        try:
            fn, extra, timing_only, kind, K = parse_variant(v, tables,
                                                            hot_bf16)
            dt = bench(fn, ids, extra, ref_out=None if timing_only
                       else ref_out)
            line = (f"{v:12s} {dt * 1e3:8.4f} ms   "
                    f"{B * S / dt / 1e6:7.1f} Mrow/s")
            if dev.type == "cuda" and kind != "prep":
                elem = extra()[0].element_size()
                bound, by = bound_ms(kind, ids, elem, K)
                line += (f"   bound {bound:.4f} ms ({by}), share "
                         f"{bound / (dt * 1e3):.3f}")
            print(line, flush=True)
        except Exception as e:  # noqa: BLE001 — report, go on
            failed.append(v)
            print(f"{v:12s} FAILED: {type(e).__name__}: {e}", flush=True)
    if failed:
        print(f"# {len(failed)} variant(s) failed: {','.join(failed)}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
