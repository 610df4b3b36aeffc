"""The benchmark's command: one run of one cell on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

It refuses (exit 2, no result) a machine without CUDA or with fewer
cards than the cell asks for; it never falls back to the CPU. Set-up
builds the port's kernels where they are not current (into
``build/kernels/`` of the checkout), makes the graph, labels and
weights on the card from the seed and warms the cell's shapes; then the
window runs ``--seconds``; then the reference checks the outputs. The
card's name and power limit come first on standard output and error
(its clocks, power draw and temperature before and after the window on
standard error);
the last line of standard output is the result, its ``checks`` (each
compared number with its limit) last, and the same checks close
standard error. A run whose process holds a module of JAX or of the JAX
package after the window exits 3 with no result.

A cell on one card runs in this process. A cell on several runs one
process a card (``ranks.py``), started before this process looks for
the cards, each card's name and power limit first on standard output;
``setup_s`` runs from this process's start to rank 0's window; where a
rank fails, dies or outlives its deadline, every rank is killed and the
command exits 1 with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def smi(fields: str, card: int = 0) -> str:
    """``nvidia-smi``'s reading of ``fields`` on ``card``, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
             "-i", str(card)], capture_output=True, text=True, timeout=60,
            check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({err})"


CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def refusal(torch, cell) -> str | None:
    """Why this machine cannot run ``cell``, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs only on the card"
    if torch.cuda.device_count() < cell.chips:
        return (f"{cell.name} needs {cell.chips} CUDA devices, found "
                f"{torch.cuda.device_count()}")
    return None


def several(args, cell):
    """A cell on several cards -> rank 0's result, or the exit code. The
    ranks start first, so that their start-up overlaps this process's
    look for the cards; where the look refuses, they are killed."""
    from port_bench import ranks

    refused = []

    def look():
        import torch

        why = refusal(torch, cell)
        if why is None:
            for r in range(cell.chips):
                print(f"# card {r}: {smi('name,power.limit', r)}",
                      flush=True)
        else:
            print(why, file=sys.stderr, flush=True)
            refused.append(why)
        return why

    result = ranks.launch(args.workload, args.seed, args.seconds,
                          bool(args.trace), cell.chips, t_start=T_START,
                          check=look)
    if result is None:
        return 2 if refused else 1
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench import spec

    cell = spec.cell(args.workload)
    if cell.chips > 1:
        result = several(args, cell)
        if isinstance(result, int):
            return result
    else:
        import torch

        from port_bench import harness, program

        why = refusal(torch, cell)
        if why is not None:
            harness.log(why)
            return 2
        torch.set_num_threads(1)
        card = smi("name,power.limit")
        print(f"# card: {card}", flush=True)
        harness.log(f"card: {card}; {CLOCKS}: {smi(CLOCKS)}")
        result = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), t_start=T_START,
            build=program.build_kernels,
            on_record=lambda rec: harness.log(
                f"after the window, {CLOCKS}: {smi(CLOCKS)}"))
    from port_bench import harness

    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the process holds modules of JAX or the JAX package: "
                    f"{loaded}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
