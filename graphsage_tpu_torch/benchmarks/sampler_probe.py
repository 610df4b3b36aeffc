"""The sampler's cost per mode on the card, the port of the JAX
package's ``benchmarks/sampler_probe.py``.

    python -m graphsage_tpu_torch.benchmarks.sampler_probe [--device cpu]

For each of the ``independent``, ``shared_perm`` and ``first_k`` modes
(``nn/sampler.py``) at bench.py's shape it times sampling alone (both
hops, no feature gather), sampling with the fused inner gather (K1),
and the full supervised train step with that mode, each chained and
timed as ``step_profile.py`` times its cases (INNER calls in a Python
loop of launches, best of ITERS; the JAX script runs them in a
``fori_loop`` inside one jit). Prints the card's name and power limit,
then one line per case, as the JAX script: ``[<mode>] <case> <ms> ms``.
A case that fails raises, and the script exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import torch

from graphsage_tpu_torch.benchmarks import bench, step_profile
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.ops.gather import fused_gather_mean

INNER = 20
ITERS = 5
MODES = ("independent", "shared_perm", "first_k")


def mode_cases(mode: str, config, optimizer, inputs) -> list:
    """(case, fn) of one sampler mode."""
    full_step = dict(step_profile.cases(config, optimizer, inputs))[
        "full_step(fwd+bwd+adam)"]

    @torch.no_grad()
    def sampling_only(params, opt_state, gen, features, adj, ids):
        s2, s3 = step_profile.sample_pyramid(gen, adj, ids, mode)
        return params, opt_state, s3.sum() * 1e-9 + s2.sum()

    @torch.no_grad()
    def sample_gather(params, opt_state, gen, features, adj, ids):
        _, s3 = step_profile.sample_pyramid(gen, adj, ids, mode)
        return params, opt_state, fused_gather_mean(features, s3).sum()

    return [("sampling_only", sampling_only),
            ("sample+inner_gather", sample_gather), ("full_step", full_step)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.sampler_probe",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {bench.card_line(device)}; ms a call, best of {ITERS} runs "
          f"of {INNER}", flush=True)
    inputs = step_profile.profile_inputs(device)
    for mode in MODES:
        config, params, optimizer, opt_state = step_profile.model(
            device, sampler_mode=mode)
        for case, fn in mode_cases(mode, config, optimizer, inputs):
            ms = step_profile.best_ms(fn, params, opt_state, inputs, device,
                                      INNER, ITERS)
            print(f"{f'[{mode}] {case}':38s} {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
