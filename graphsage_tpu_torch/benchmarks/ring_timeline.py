"""K7a's timeline: when block 0 of the probe's ring kernel fills, waits
for and sums each of its items, from clock64() stamps.

    python -m graphsage_tpu_torch.benchmarks.ring_timeline --dist zipf

Builds ``ops/csrc/gather_probe.cu`` a second time with
``GRAPHSAGE_RING_STAMPS`` defined (``build/kernels/
libgather_probe_stamps.so``; the default build has no stamps) and runs
each K7a instance through its wrapper at the probe's shape (B = 1024,
S = 25, F = 640 f32, N = 100k; ``benchmarks/gather_probe.py``'s ids
and table), on that build. For each instance it prints the mean over
block 0's items, in SM cycles, of: the producers' wait for a free stage,
their issue of the stage's copies, the consumers' wait for the stage's
ids, their wait for its first copies, and their sum; then the block's
span (first fill to last sum), and the instance's time per call on the
stamped build beside the default one (``benchmarks/gather_probe.py``'s
timing). Where the sums of a consumer group's items fill its span, the
consumers set K7a's pace; where the consumers wait on data, the copies
do. Runs on a card only.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import gather_probe as probe
from graphsage_tpu_torch.ops import build
from graphsage_tpu_torch.ops import gather_probe as probe_ops

STAMP_ITEMS = 32      # the kernel's kStampItems
EVENTS = ("fill", "free", "issued", "take", "ids", "data", "summed")
CONSUMER_GROUPS = 2   # the kernel's kConsumerGroups
SEGMENTS = (          # (name, from event, to event)
    ("stage wait", "fill", "free"),
    ("issue", "free", "issued"),
    ("ids wait", "take", "ids"),
    ("data wait", "ids", "data"),
    ("sum", "data", "summed"),
)


def build_stamped() -> ctypes.CDLL:
    """The stamped build of gather_probe.cu, compiled afresh."""
    src = build.CSRC / "gather_probe.cu"
    lib = build.BUILD_DIR / "libgather_probe_stamps.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DGRAPHSAGE_RING_STAMPS",
         "-o", str(lib), str(src)],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def use_library(lib: ctypes.CDLL) -> None:
    """Route the K7a wrappers' launches through ``lib``."""
    def fn(symbol: str, argtypes: tuple):
        f = getattr(lib, symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        return f

    probe_ops._fn = fn


def read_stamps(lib: ctypes.CDLL) -> np.ndarray:
    """[STAMP_ITEMS, len(EVENTS)] int64 stamps, zeroed on the card."""
    out = np.zeros((STAMP_ITEMS, len(EVENTS)), np.int64)
    err = lib.graphsage_probe_ring_stamps(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    if err:
        raise RuntimeError(f"reading the stamps: CUDA error {err}")
    return out


def timeline(stamps: np.ndarray) -> dict:
    """Mean cycles of each segment over the stamped items, the block's
    span, and each consumer group's summing share of it."""
    col = {e: i for i, e in enumerate(EVENTS)}
    items = stamps[stamps[:, col["summed"]] != 0]
    t0 = items[:, col["fill"]].min()
    out = {"items": len(items),
           "span": int(items[:, col["summed"]].max() - t0)}
    for name, a, b in SEGMENTS:
        have = items[(items[:, col[a]] != 0) & (items[:, col[b]] != 0)]
        out[name] = float(np.mean(have[:, col[b]] - have[:, col[a]]))
    # a group takes every CONSUMER_GROUPS-th item; its busy share is
    # its items' sums over the span (an item with no live slot, which
    # has no data stamp, sums from its ids on)
    data = np.where(items[:, col["data"]] != 0, items[:, col["data"]],
                    items[:, col["ids"]])
    sums = items[:, col["summed"]] - data
    out["sum share"] = float(max(
        sums[g::CONSUMER_GROUPS].sum() for g in range(CONSUMER_GROUPS))
        / out["span"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist", default="zipf", choices=("zipf", "uniform"))
    ap.add_argument("--K", type=int, default=1024,
                    help="hot rows of the hot and compacted instances")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_timeline: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(probe.make_table(rng)).to(dev)
    ids = torch.from_numpy(probe.make_ids(args.dist, rng, 4)).to(dev)
    runs = {name: probe.build_call(kind, torch.float32, K=args.K)
            for name, kind in (("sample", "plain"), ("row", "bulkwait"),
                               ("tile", "tilewait"),
                               (f"hot{args.K}", "hot"),
                               (f"compacted{args.K}", "coldsw"))}
    # each instance's time on the default build, then on the stamped one
    # (benchmarks/gather_probe.py's timing; compacted with its compaction)
    plain_ms = {name: probe.bench(fn, ids, lambda: (table,)) * 1e3
                for name, fn in runs.items()}
    lib = build_stamped()
    use_library(lib)
    print(f"# K7a timeline, dist={args.dist} B={probe.B} S={probe.S} "
          f"F={probe.F} N={probe.N}, block 0, SM cycles, on "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    for name, fn in runs.items():
        fn(ids[0], table)
        torch.cuda.synchronize()
        read_stamps(lib)
        fn(ids[0], table)
        torch.cuda.synchronize()
        t = timeline(read_stamps(lib))
        ms = probe.bench(fn, ids, lambda: (table,)) * 1e3
        segs = ", ".join(f"{s} {t[s]:.0f}" for s, _, _ in SEGMENTS)
        print(f"{name:14s} items {t['items']}: per item {segs}; span "
              f"{t['span']}, a group's sums {t['sum share']:.3f} of it; "
              f"{ms:.4f} ms a call stamped, {plain_ms[name]:.4f} not",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
