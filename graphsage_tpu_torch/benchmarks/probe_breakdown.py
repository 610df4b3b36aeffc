"""What K7b's and K7c's time is made of on the card: each kernel's device
time (torch.profiler) at the probe's shape (B 1024, S 25, F 640, zipf
ids over N = 100k; the calls cycle over 4 id sets, as chip_smoke.py
times them), K 0, 1024 and 4096, as built and with one part switched
off in a copy of the source.

    python -m graphsage_tpu_torch.benchmarks.probe_breakdown

A copy is the checkout's ``ops/csrc/gather_probe.cu`` with text
replaced, built under ``build/probe_breakdown/`` with the same nvcc
flags and loaded in place of the library. A copy with a part switched
off computes a wrong result by design: only its time is read. Needs a
card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import gather_probe as gp
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.ops import build
from graphsage_tpu_torch.ops import gather_probe as ops

# each copy: (text of the source, its replacement), every text found once
VARIANTS = {
    "as built": [],
    # the count windows stay zero: no row's counts are written
    "no count writes": [
        ("      if (t < kCountRows) {\n        move_window",
         "      if (false) {\n        move_window"),
        ("      if (t < R) {\n        move_window",
         "      if (false) {\n        move_window"),
    ],
    # K7c's cold warps sum nothing
    "no cold half": [
        ("for (int i0 = t - kConsumers - 32; i0 < kItems;",
         "for (int i0 = kItems; i0 < kItems;"),
    ],
}
KS = (0, 1024, 4096)
PROFILED_CALLS = 20


def variant_source(name: str, text: str) -> str:
    """The source of copy ``name``: each text replaced where it occurs
    once; ValueError where it does not."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             "times in gather_probe.cu")
        text = text.replace(old, new)
    return text


def build_variants(names) -> dict:
    """{name: loaded library}, every copy compiled at once."""
    text = (build.CSRC / "gather_probe.cu").read_text()
    root = build.BUILD_DIR.parent / "probe_breakdown"
    procs = {}
    for i, name in enumerate(names):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "gather_probe.cu").write_text(variant_source(name, text))
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "gather_probe.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def device_us(fn, idx_sets) -> float:
    """Mean device microseconds of the probe kernels a call of fn(idx),
    the calls cycling over idx_sets."""
    from torch.profiler import ProfilerActivity, profile

    for idx in idx_sets:
        fn(idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_CALLS):
            fn(idx_sets[i % len(idx_sets)])
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA" and "probe_" in e.key)
    return total / PROFILED_CALLS


def main() -> int:
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(gp.N + 1, gp.F, generator=gen, device=dev)
    table[gp.N] = 0
    t16 = table.to(torch.bfloat16)
    sets = list(torch.from_numpy(
        gp.make_ids("zipf", np.random.default_rng(0), 4)).to(dev))
    print(f"# K7b and K7c device us at idx [{gp.B},{gp.S}] into "
          f"[{gp.N + 1},{gp.F}], zipf; K7c at {ops.MX_TILE_B} rows; on "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    libs = build_variants(list(VARIANTS))
    load = build.load
    try:
        for name, lib in libs.items():
            build.load = lambda source, lib=lib: lib
            ops._fn.cache_clear()
            times = []
            for K in KS:
                times.append(device_us(lambda idx: ops.probe_hotcount(
                    idx, t16[:K]), sets))
                times.append(device_us(lambda idx: ops.probe_hotmx(
                    table, idx, K), sets))
            print(f"{name:16s} " + "  ".join(
                f"K{K} K7b {times[2 * i]:.1f} K7c {times[2 * i + 1]:.1f}"
                for i, K in enumerate(KS)), flush=True)
    finally:
        build.load = load
        ops._fn.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
