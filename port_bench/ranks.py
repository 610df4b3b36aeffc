"""A cell over several cards: one process a card, started and watched by
the command.

``launch`` (the command's side) starts ``world`` rank processes,
``python3 -m port_bench.ranks``, from the checkout's root, rank r on
``cuda:r`` (or the CPU, for tests). Each joins the others in a process
group (NCCL on cards, gloo on the CPU) and a gloo group for the
harness's own barriers and gathers, then runs ``harness.run_cell`` with
its ``Ranks``; the barrier before the window opens every window
together. A rank's standard error and output reach the command's
standard error, each line headed ``[rank r]``; only the command writes
to standard output, rank 0's result last. Where a rank fails, dies or
outlives a deadline (``setup_deadline_s`` from the command's start
until rank 0's window opens, ``after_window_s`` past the window's end
after that), the command kills every rank and their children, and
``launch`` returns None: no result. A rank dies with the command
(``PR_SET_PDEATHSIG``), and each runs the check for modules of JAX or
the JAX package. Nothing here comes from the port's own launcher, so a
change to the port cannot change how the benchmark starts.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import datetime
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

SETUP_DEADLINE_S = 900.0    # the first run of a cell builds its kernels
AFTER_WINDOW_S = 240.0      # the check, the trace's reduction, the exit
GROUP_TIMEOUT_S = 1800.0    # a collective's; the deadlines come first
WINDOW = "port_bench.window"
RESULT = '{"correct"'


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Watch:
    """The rank processes and the threads that copy their lines."""

    def __init__(self):
        self.procs, self.threads = [], []
        self.lock = threading.Lock()
        self.result = None
        self.opened = None      # when rank 0's window opened

    def add(self, proc) -> None:
        rank = len(self.procs)
        self.procs.append(proc)
        for stream in (proc.stdout, proc.stderr):
            t = threading.Thread(target=self._copy, args=(rank, stream),
                                 daemon=True)
            t.start()
            self.threads.append(t)

    def _copy(self, rank: int, stream) -> None:
        for line in stream:
            line = line.rstrip("\n")
            if rank == 0 and line == WINDOW:
                self.opened = time.perf_counter()
                continue
            if rank == 0 and line.startswith(RESULT):
                self.result = line
                continue
            with self.lock:
                print(f"[rank {rank}] {line}", file=sys.stderr, flush=True)

    def wait(self, t_start, seconds, setup_deadline_s, after_window_s):
        """-> None when every rank exited 0, else why not."""
        while True:
            codes = [p.poll() for p in self.procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                return f"rank {bad[0][0]} exited with {bad[0][1]}"
            if all(c == 0 for c in codes):
                return None
            now = time.perf_counter()
            if self.opened is None and now > t_start + setup_deadline_s:
                return (f"no window opened {setup_deadline_s} s after the "
                        "start")
            if (self.opened is not None
                    and now > self.opened + seconds + after_window_s):
                return (f"ranks still running {after_window_s} s after the "
                        "window closed")
            time.sleep(0.05)

    def end(self) -> None:
        """Kill every rank's process group (a rank that exited may have
        left a child), reap them and drain their lines."""
        for p in self.procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in self.procs:
            p.wait()
        for t in self.threads:
            t.join(timeout=10.0)


class _Terminated(Exception):
    pass


def _on_term(signum, frame):
    raise _Terminated(signum)


def launch(workload: str, seed: int, seconds: float, trace: bool,
           world: int, device: str = "cuda", t_start: float | None = None,
           root=None, program: str = "port", fault: str | None = None,
           check=None, setup_deadline_s: float = SETUP_DEADLINE_S,
           after_window_s: float = AFTER_WINDOW_S):
    """Run cell ``workload`` over ``world`` rank processes started in
    ``root`` (the checkout's root) -> rank 0's result dict, or None when
    ``check()``, called once the ranks are started, says why not, or a
    rank failed, died or outlived a deadline (every rank is then
    killed). ``program`` and ``fault`` (a name of ``faults.py``, or
    ``module:name``, planted on every rank) are for calibration."""
    from port_bench import spec

    root = spec.ROOT if root is None else root
    t_start = time.perf_counter() if t_start is None else t_start
    init = f"tcp://127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-u", "-m", "port_bench.ranks",
           "--workload", workload, "--seed", str(seed),
           "--seconds", repr(float(seconds)), "--trace", str(int(trace)),
           "--world", str(world), "--init", init, "--t_start", repr(t_start),
           "--device", device, "--program", program,
           "--parent", str(os.getpid())]
    if fault is not None:
        cmd += ["--fault", fault]
    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _on_term) if main_thread else None
    watch = _Watch()
    try:
        for r in range(world):
            watch.add(subprocess.Popen(
                cmd + ["--rank", str(r)], cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True))
        why = None if check is None else check()
        if why is None:
            why = watch.wait(t_start, seconds, setup_deadline_s,
                             after_window_s)
    except _Terminated:
        why = "terminated"
    finally:
        watch.end()
        if main_thread:
            signal.signal(signal.SIGTERM, old)
    if why is None and watch.result is None:
        why = "rank 0 printed no result"
    if why is not None:
        print(f"{world} ranks: {why}; every rank killed, no result",
              file=sys.stderr, flush=True)
        return None
    return json.loads(watch.result)


# ------------------------------------------------------------ a rank

def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when the command exits (Linux)."""
    try:
        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(9)


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.ranks")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--t_start", type=float, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--program", choices=("port", "control"), default="port")
    p.add_argument("--fault", default=None)
    p.add_argument("--parent", type=int, required=True)
    return p.parse_args(argv)


def _planted(fault: str | None):
    if fault is None:
        return contextlib.nullcontext()
    module, _, name = fault.rpartition(":")
    return importlib.import_module(module or "port_bench.faults").planted(
        name)


def rank_main(argv=None) -> int:
    args = _parse(argv)
    _die_with_parent(args.parent)
    import torch
    import torch.distributed as dist

    from port_bench import harness, program, run, spec

    t_up = time.perf_counter()
    rank, world = args.rank, args.world
    torch.set_num_threads(1)
    if args.device == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=args.init, world_size=world,
                            rank=rank, timeout=timeout)
    control = dist.group.WORLD
    if device.type == "cuda":
        control = dist.new_group(backend="gloo", timeout=timeout)
        one = torch.ones(1, device=device)
        dist.all_reduce(one)       # the NCCL communicator is made here
        torch.cuda.synchronize()
    dist.barrier(group=control)
    joined = time.perf_counter() - args.t_start
    harness.log(f"joined {world} ranks {joined:.3f} s after the start, "
                f"imports done at {t_up - args.t_start:.3f} s ({args.init})")
    cell = spec.cell(args.workload)

    def opened():
        print(WINDOW, flush=True)

    def after(rec):
        if device.type == "cuda":
            harness.log(f"after the window, {run.CLOCKS}: "
                        f"{run.smi(run.CLOCKS, rank)}")

    ranks = harness.Ranks(rank, world, dist.group.WORLD, control, opened)
    with _planted(args.fault):
        result = harness.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), device,
            program=args.program, t_start=args.t_start,
            build=program.build_kernels if device.type == "cuda" else None,
            on_record=after, ranks=ranks)
    dist.barrier(group=control)    # rank 0's check is done
    dist.destroy_process_group()
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the process holds modules of JAX or the JAX package: "
                    f"{loaded}")
        return 3
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
