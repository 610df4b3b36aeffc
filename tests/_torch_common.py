"""Shared helpers of the PyTorch port's parity tests.

Inputs are made with NumPy from a seed and handed to both packages; the
JAX side runs on the CPU as the rest of the suite does.
"""

import jax
import numpy as np
import torch

# six xdist workers share the machine
torch.set_num_threads(2)


def t(x) -> torch.Tensor:
    """NumPy (or a JAX array) -> CPU tensor."""
    return torch.from_numpy(np.array(x, copy=True))


def port_params(jax_params, model_shard=None) -> dict:
    """JAX pytree -> the port's flat dict, through the weight bridge;
    with ``model_shard`` = (sage_config, n_model, index), rank index's
    shard of the logical params (``params_to_model_shard``), as a
    tensor-parallel rank holds them. ``jax.device_get`` of a tree that
    GSPMD placed split gives its logical, whole arrays."""
    from graphsage_tpu_torch.params import (
        params_from_jax,
        params_to_model_shard,
    )

    flat = params_from_jax(jax.device_get(jax_params))
    if model_shard is None:
        return flat
    return params_to_model_shard(flat, *model_shard)


def run_rank_checks(jobs: dict, n_ranks: int, tmp_dir) -> list:
    """Run ``jobs`` through ``parallel/launch.py::check_rank`` in
    ``n_ranks`` spawned gloo processes (a ``file://`` store under
    ``tmp_dir``, one thread each, joined within 120 s: a hung group
    fails) -> each rank's outputs, in rank order."""
    import os

    from graphsage_tpu_torch.parallel import launch

    tmp_dir = str(tmp_dir)
    job_path = os.path.join(tmp_dir, "jobs.pt")
    torch.save(jobs, job_path)
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        launch.spawn(launch.check_rank, (job_path, tmp_dir),
                     [torch.device("cpu")] * n_ranks,
                     f"file://{tmp_dir}/store", timeout_s=120)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n_ranks)]


def run_cli(argv: list, tmp_dir, timeout: float = 120) -> str:
    """``python -m graphsage_tpu_torch <argv>`` (``run_clis`` of one)."""
    return run_clis([(argv, {})], tmp_dir, timeout)[0]


def run_clis(runs: list, tmp_dir, timeout: float = 120,
             module: str = "graphsage_tpu_torch") -> list:
    """``python -m <module> <argv>`` for each (argv, extra
    environment) of ``runs``, started together, each in a process group
    of its own, one thread a process, every group killed past
    ``timeout`` seconds (a hung run fails its test); returns their
    stdouts and fails on a non-zero exit. TensorFlow is kept out of the
    runs by a package that fails to import (TensorBoard then writes
    through its own stub): where it is installed, its import costs
    seconds a process, and these runs are checked by their stats files,
    not by TensorBoard's events."""
    import os
    import signal
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    stub = os.path.join(str(tmp_dir), "no_tensorflow")
    os.makedirs(os.path.join(stub, "tensorflow"), exist_ok=True)
    with open(os.path.join(stub, "tensorflow", "__init__.py"), "w") as fp:
        fp.write('raise ImportError("TensorFlow is kept out of this run")\n')
    path = [stub, root] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv], cwd=root,
        env={**env, **extra}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True) for argv, extra in runs]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return outs
