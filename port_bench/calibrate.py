"""The readings a cell's limits and rate are set from, made once on the
card when a cell is defined; the benchmark's own runs never run this.

    python3 -m port_bench.calibrate readings --workload <cell> \
        --seeds 1,2,... [--control_seeds ...] [--fault_seeds ...] \
        [--seconds 2]
    python3 -m port_bench.calibrate knee --workload <cell> \
        --rates 300,350,... [--seconds 5] [--seed 1]

``readings`` runs the cell in one process for each seed, each run with a
short window, and prints one JSON line a run with the compared numbers:
the port's (the lower readings), the control's (the reference in TF32
put in the port's place: the upper readings) and each fault's that the
cell can have (``faults.py``). ``knee`` serves a requests cell at each
rate and prints the latency's quantiles and whether the backlog grew:
the mean latency of the last tenth of the requests against the first.
Pass ``--device cpu`` to rehearse either at a toy size in a test.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from port_bench import faults, harness, program, spec


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seeds, control_seeds, fault_seeds, seconds, device):
    out = []

    def run(seed, kind, fault=None):
        if fault is None:
            r = harness.run_cell(cell, seed, seconds, False, device,
                                 program=kind)
        else:
            with faults.planted(fault):
                r = harness.run_cell(cell, seed, seconds, False, device)
        line = {"workload": cell.name, "seed": seed, "program": kind,
                "fault": fault, "correct": r["correct"],
                "numbers": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        out.append(line)

    for seed in seeds:
        run(seed, "port")
    for seed in control_seeds:
        run(seed, "control")
    for fault in faults.FOR_MODE[cell.traffic["mode"]]:
        for seed in fault_seeds:
            run(seed, "port", fault)
    return out


def knee(cell, rates, seconds, seed, device):
    out = []
    for rate in rates:
        cell.traffic = dict(cell.traffic, rate_per_s=rate)
        recs = []
        harness.run_cell(cell, seed, seconds, False, device,
                         on_record=recs.append)
        lat = np.asarray(recs[0]["lat"]) * 1e3
        tenth = max(1, len(lat) // 10)
        line = {"workload": cell.name, "rate_per_s": rate,
                "served": int(len(lat)), "failed": recs[0]["failed"],
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "first_tenth_mean_ms": float(lat[:tenth].mean()),
                "last_tenth_mean_ms": float(lat[-tenth:].mean())}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    p.add_argument("what", choices=("readings", "knee"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    cell = spec.cell(args.workload)
    if device.type == "cuda":
        torch.set_num_threads(1)
        harness.log(program.build_kernels(cell.config)[-2000:])
    if args.what == "readings":
        readings(cell, _seeds(args.seeds), _seeds(args.control_seeds),
                 _seeds(args.fault_seeds), args.seconds, device)
    else:
        knee(cell, [float(r) for r in args.rates.split(",")], args.seconds,
             args.seed, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
