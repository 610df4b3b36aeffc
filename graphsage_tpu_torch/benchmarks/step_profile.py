"""Decompose the supervised train step's time on the card, the port of
the JAX package's ``benchmarks/step_profile.py``.

    python -m graphsage_tpu_torch.benchmarks.step_profile [--device cpu]

At bench.py's shape (zipf adjacency, GraphSAGE-mean with the fused
gather-mean K1, the ``shared_perm`` sampler) it times five cases: the
full step (forward, backward, Adam), the forward loss, ``sage_embed``
alone, the sampler with both feature gathers, and the sampler with the
inner gather alone. Each case runs INNER times in sequence, the ids of
each call moved by the last output times 0 (a data dependency, as the
JAX script's ``chained``), and is timed best of ITERS around one read
of the last output. The JAX script runs the INNER calls in a
``fori_loop`` inside one jit; here they are a Python loop of launches,
so the host's launch cost is in the times. The cases without a
backward run under ``torch.no_grad``.

Prints the card's name and power limit, then one line per case, as the
JAX script: ``<case> <ms> ms``. A case that fails raises, and the
script exits non-zero (the JAX script prints FAILED and goes on).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import bench
from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.nn.sampler import uniform_sample
from graphsage_tpu_torch.ops.gather import fused_gather_mean

INNER = 20
ITERS = 5


def profile_inputs(device) -> dict:
    """The JAX scripts' inputs from ``default_rng(0)``: the feature table,
    the zipf adjacency, one batch's one-hot labels, mask and ids."""
    rng = np.random.default_rng(0)
    features = bench.feature_table(rng)
    adj = bench.zipf_adjacency(rng)
    labels = np.eye(bench.NUM_CLASSES, dtype=np.float32)[
        rng.integers(0, bench.NUM_CLASSES, (bench.BATCH,))]
    ids = rng.integers(0, bench.NUM_NODES, (bench.BATCH,), dtype=np.int32)
    return {"features": torch.from_numpy(features).to(device),
            "adj": torch.from_numpy(adj).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "mask": torch.ones(bench.BATCH, device=device),
            "ids": torch.from_numpy(ids).to(device)}


def model(device, sampler_mode: str = "shared_perm"):
    """(config, params, optimizer, opt_state): bench.py's model, weights
    from torch seed 0, Adam at lr 1e-2."""
    from graphsage_tpu_torch.models.supervised import (
        SupervisedConfig,
        init_supervised_params,
        make_optimizer,
    )

    config = SupervisedConfig(
        sage=bench.sage_config(True, sampler_mode=sampler_mode),
        num_classes=bench.NUM_CLASSES)
    params = init_supervised_params(torch.Generator().manual_seed(0), config,
                                    device=device)
    optimizer = make_optimizer(bench.LEARNING_RATE)
    return config, params, optimizer, optimizer.init(params)


def chained(fn, device, inner: int):
    """many(params, opt_state, features, adj, ids) -> the last output
    times 0, on the device: ``inner`` calls of ``fn(params, opt_state,
    generator, features, adj, ids_i)`` -> (params, opt_state, out), the
    ids of each moved by the previous output (times 0). The sampler's
    generator is seeded 3 each time, so every run draws alike."""

    def many(params, opt_state, features, adj, ids):
        gen = torch.Generator(device=device).manual_seed(3)
        acc = torch.zeros((), device=device)
        for _ in range(inner):
            ids_i = (ids + acc.long()) % bench.NUM_NODES
            params, opt_state, out = fn(params, opt_state, gen, features,
                                        adj, ids_i)
            acc = out.detach().float() * 0.0
        return acc

    return many


def best_ms(fn, params, opt_state, inputs, device, inner: int,
            iters: int) -> float:
    """ms a call of ``fn``: one warm-up run of ``chained(fn)``, then the
    best of ``iters``, each ended by reading its output."""
    many = chained(fn, device, inner)
    args = (params, opt_state, inputs["features"], inputs["adj"],
            inputs["ids"])
    float(many(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        float(many(*args))
        best = min(best, time.perf_counter() - t0)
    return best / inner * 1e3


def sample_pyramid(gen, adj, ids, mode: str = "shared_perm"):
    """The two hops' samples: [B*S2] and [B*S2, S1], contiguous (first_k
    slices columns)."""
    s2 = uniform_sample(gen, adj, ids, bench.FANOUTS[1], mode=mode)
    s2 = s2.reshape(-1)
    return s2, uniform_sample(gen, adj, s2, bench.FANOUTS[0],
                              mode=mode).contiguous()


def cases(config, optimizer, inputs) -> list:
    """(name, fn) of the five cases."""
    from graphsage_tpu_torch.models.graphsage import sage_embed
    from graphsage_tpu_torch.models.supervised import supervised_loss

    labels, mask = inputs["labels"], inputs["mask"]

    def full_step(params, opt_state, gen, features, adj, ids):
        opt_state.zero_grad(set_to_none=True)
        loss, _ = supervised_loss(params, features, adj, ids, labels, mask,
                                  config, generator=gen, deterministic=False)
        loss.backward()
        optimizer.update(opt_state, params)
        return params, opt_state, loss

    @torch.no_grad()
    def fwd_only(params, opt_state, gen, features, adj, ids):
        loss, _ = supervised_loss(params, features, adj, ids, labels, mask,
                                  config, generator=gen, deterministic=False)
        return params, opt_state, loss

    @torch.no_grad()
    def embed_only(params, opt_state, gen, features, adj, ids):
        out = sage_embed(params, features, adj, ids, config.sage,
                         generator=gen, deterministic=True)
        return params, opt_state, out.sum()

    @torch.no_grad()
    def gathers_only(params, opt_state, gen, features, adj, ids):
        # the sample pyramid and the two feature gathers, no aggregation
        s2, s3 = sample_pyramid(gen, adj, ids)
        h3 = fused_gather_mean(features, s3)
        h2 = features.index_select(0, s2)
        return params, opt_state, h3.sum() + h2.sum()

    @torch.no_grad()
    def inner_gather_only(params, opt_state, gen, features, adj, ids):
        _, s3 = sample_pyramid(gen, adj, ids)
        return params, opt_state, fused_gather_mean(features, s3).sum()

    return [("full_step(fwd+bwd+adam)", full_step),
            ("forward_loss_only", fwd_only),
            ("sage_embed_only", embed_only),
            ("sample+gathers_only", gathers_only),
            ("sample+inner_gather", inner_gather_only)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.step_profile",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {bench.card_line(device)}; ms a call, best of {ITERS} runs "
          f"of {INNER}", flush=True)
    inputs = profile_inputs(device)
    config, params, optimizer, opt_state = model(device)
    for name, fn in cases(config, optimizer, inputs):
        ms = best_ms(fn, params, opt_state, inputs, device, INNER, ITERS)
        print(f"{name:26s} {ms:8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
