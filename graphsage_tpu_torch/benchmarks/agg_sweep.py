"""Chunked-mode training throughput per aggregator on the card, the port
of the JAX package's ``benchmarks/agg_sweep.py``.

    python -m graphsage_tpu_torch.benchmarks.agg_sweep mean meanpool_fused
        [--device cpu] [--out PATH]

Each named config (``CONFIGS``, JAX's 27, key for key) trains bench.py's
shape (100k nodes, 602 features, zipf(1.05) adjacency unless the config
says ``uniform`` or ``zipf_scattered``; ``:bf16`` builds a bfloat16
table) through the port's chunk runners (``parallel/dp.py``): 2 warm-up
chunks, then the best of 3 timed chunks of ITERS steps, each ended by
reading the loss. Supervised: Adam at lr 1e-2, ids and labels from
``default_rng(3)``; unsupervised: 20 negatives from the unigram^0.75 CDF
of degrees all 128, lr 1e-5, pairs and the negatives' uniforms from
``default_rng(5)``, (2B + 20)(S2 + S2*S1) edges a step over the three
towers. The innermost hop follows the port's routes
(``models/graphsage.py::sage_embed``): fused mean and gcn take the
gather-mean kernel (K1; K2 with dropout), fused meanpool the
gather-MLP-pool (K6 in training), maxpool and seq no kernel. Each config
prints one JSON line with the JAX script's keys and the card's name and
power limit, and appends it to ``--out`` (``AGG_SWEEP_H100.jsonl``
beside this file). The JAX script's TPU preflight does not carry over.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import bench
from graphsage_tpu_torch.device import resolve_device

NUM_NODES = 100_000
FEAT_DIM = 602
NUM_CLASSES = 41
MAX_DEGREE = 128
BATCH = 512
FANOUTS = (25, 10)
DIMS = (128, 128)
ITERS = 100          # steps per chunk
WARMUP_CHUNKS = 2
TRIALS = 3
NEG_SAMPLES = 20
OUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "AGG_SWEEP_H100.jsonl")

# (aggregator, model_size, fused, dist, identity_dim, unsup[, dropout])
# dist may carry a ":bf16" suffix to build the feature table in bfloat16
CONFIGS = {
    "mean":         ("mean",     "small", True,  "zipf",    0, False),
    "mean_nofused": ("mean",     "small", False, "zipf",    0, False),
    "gcn":          ("gcn",      "small", True,  "zipf",    0, False),
    "maxpool":      ("maxpool",  "small", False, "zipf",    0, False),
    "meanpool":     ("meanpool", "small", False, "zipf",    0, False),
    "maxpool_fused":  ("maxpool",  "small", True, "zipf",   0, False),
    "meanpool_fused": ("meanpool", "small", True, "zipf",   0, False),
    "maxpool_big_fused": ("maxpool", "big", True, "zipf",   0, False),
    "meanpool_big_fused": ("meanpool", "big", True, "zipf", 0, False),
    "seq":          ("seq",      "small", False, "zipf",    0, False),
    "seq_fused":    ("seq",      "small", True,  "zipf",    0, False),
    "seq_big_fused": ("seq",     "big",   True,  "zipf",    0, False),
    "maxpool_big":  ("maxpool",  "big",   False, "zipf",    0, False),
    "meanpool_big": ("meanpool", "big",   False, "zipf",    0, False),
    "seq_big":      ("seq",      "big",   False, "zipf",    0, False),
    "mean_uniform": ("mean",     "small", True,  "uniform", 0, False),
    # zipf degree skew with the hub ids scattered over the id space
    "mean_zipf_scattered": ("mean", "small", True, "zipf_scattered",
                            0, False),
    "identity64":   ("mean",     "small", True,  "zipf",   64, False),
    "unsup_mean":   ("mean",     "small", True,  "zipf",    0, True),
    # trailing element: the dropout rate (the runners train with it)
    "mean_drop":           ("mean", "small", True,  "zipf", 0, False, 0.5),
    "mean_nofused_drop":   ("mean", "small", False, "zipf", 0, False, 0.5),
    "meanpool_fused_drop": ("meanpool", "small", True, "zipf", 0, False,
                            0.5),
    "meanpool_drop":       ("meanpool", "small", False, "zipf", 0, False,
                            0.5),
    "maxpool_bf16":      ("maxpool", "small", False, "zipf:bf16", 0, False),
    "seq_bf16":          ("seq",     "small", False, "zipf:bf16", 0, False),
    "mean_nofused_bf16": ("mean",    "small", False, "zipf:bf16", 0, False),
    "meanpool_bf16":     ("meanpool", "small", False, "zipf:bf16", 0,
                          False),
}


def build_graph(dist: str, device="cpu"):
    """(features [N+1, F], adjacency [N+1, max_degree] int32) on
    ``device``, drawn from ``default_rng(0)`` as agg_sweep.py's
    ``build_graph``: zipf, zipf with the ids scattered by a permutation,
    or uniform; ``:bf16`` rounds the table to bfloat16."""
    dist, _, tag = dist.partition(":")
    rng = np.random.default_rng(0)
    features = np.vstack([
        rng.standard_normal((NUM_NODES, FEAT_DIM)).astype(np.float32),
        np.zeros((1, FEAT_DIM), dtype=np.float32)])
    if dist in ("zipf", "zipf_scattered"):
        adj = bench.zipf_adjacency(rng, num_nodes=NUM_NODES,
                                   max_degree=MAX_DEGREE)
        if dist == "zipf_scattered":
            adj = rng.permutation(NUM_NODES).astype(np.int32)[adj]
    else:
        adj = rng.integers(0, NUM_NODES, (NUM_NODES + 1, MAX_DEGREE),
                           dtype=np.int32)
    table = torch.from_numpy(features).to(device)
    if tag == "bf16":
        table = table.to(torch.bfloat16)
    return table, torch.from_numpy(adj).to(device)


def make_sage(agg, model_size, fused, identity_dim, dropout=0.0):
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig

    return SAGEConfig(
        layers=(LayerInfo(FANOUTS[0], DIMS[0]),
                LayerInfo(FANOUTS[1], DIMS[1])),
        feature_dim=FEAT_DIM, aggregator=agg, concat=agg != "gcn",
        model_size=model_size, identity_dim=identity_dim,
        num_nodes=NUM_NODES, fused_gather=fused, dropout=dropout)


def time_chunks(run_chunk, fetch_loss) -> float:
    """WARMUP_CHUNKS warm-up chunks, then the best of TRIALS timed
    chunks, each ended by reading the loss back: seconds a step."""
    for _ in range(WARMUP_CHUNKS):
        state = run_chunk()
    fetch_loss(state)
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        state = run_chunk()
        fetch_loss(state)
        best = min(best, time.perf_counter() - t0)
    return best / ITERS


def _fetch(state) -> None:
    loss = float(state["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"


def edges_per_step(unsupervised: bool) -> int:
    """Sampled edges a step: the batch's roots (supervised), or the three
    towers' (b1 + b2 + negatives), each expanded S2 + S2*S1."""
    roots = 2 * BATCH + NEG_SAMPLES if unsupervised else BATCH
    return roots * (FANOUTS[1] + FANOUTS[1] * FANOUTS[0])


def run_supervised(name, agg, model_size, fused, dist, identity_dim,
                   dropout=0.0, device="cpu"):
    """(seconds a step, edges a step) of one supervised config."""
    from graphsage_tpu_torch.models.supervised import (
        SupervisedConfig,
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner

    device = torch.device(device)
    sup = SupervisedConfig(
        sage=make_sage(agg, model_size, fused, identity_dim, dropout),
        num_classes=NUM_CLASSES, sigmoid_loss=False, weight_decay=0.0)
    features, adj = build_graph(dist, device)
    rng_np = np.random.default_rng(3)
    params = init_supervised_params(torch.Generator().manual_seed(0), sup,
                                    device=device)
    optimizer = make_optimizer(1e-2)
    runner = make_supervised_chunk_runner(sup, optimizer, BATCH)
    labels_table = np.zeros((NUM_NODES + 1, NUM_CLASSES), np.float32)
    labels_table[np.arange(NUM_NODES),
                 rng_np.integers(0, NUM_CLASSES, NUM_NODES)] = 1.0
    labels_dev = torch.from_numpy(labels_table).to(device)
    n_total = (WARMUP_CHUNKS + TRIALS) * ITERS
    ids_perm = torch.from_numpy(rng_np.integers(
        0, NUM_NODES, (n_total * BATCH,), dtype=np.int32)).to(device)
    gen = torch.Generator(device=device).manual_seed(11)
    state = {"params": params, "opt": optimizer.init(params), "start": 0,
             "loss": None}

    def run_chunk():
        state["params"], state["opt"], state["loss"], *_ = runner(
            state["params"], state["opt"], gen, features, adj, ids_perm,
            labels_dev, state["start"], ITERS, drop_seed=11)
        state["start"] += ITERS
        return state

    return time_chunks(run_chunk, _fetch), edges_per_step(False)


def run_unsupervised(name, agg, model_size, fused, dist, identity_dim,
                     dropout=0.0, device="cpu"):
    """(seconds a step, edges a step over the three towers) of one
    unsupervised config."""
    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        UnsupervisedConfig,
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.nn.negative import (
        negatives_from_uniforms,
        unigram_cdf,
    )
    from graphsage_tpu_torch.parallel.dp import (
        make_unsupervised_chunk_runner,
    )

    device = torch.device(device)
    uconf = UnsupervisedConfig(
        sage=make_sage(agg, model_size, fused, identity_dim, dropout))
    features, adj = build_graph(dist, device)
    rng_np = np.random.default_rng(5)
    params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                      uconf, device=device)
    optimizer = make_optimizer(1e-5)
    runner = make_unsupervised_chunk_runner(uconf, optimizer, BATCH)
    cdf = torch.from_numpy(unigram_cdf(
        np.full((NUM_NODES + 1,), float(MAX_DEGREE), np.float32))).to(device)
    n_total = (WARMUP_CHUNKS + TRIALS) * ITERS
    pairs = torch.from_numpy(rng_np.integers(
        0, NUM_NODES, (n_total * BATCH, 2), dtype=np.int32)).to(device)
    negs = negatives_from_uniforms(cdf, torch.from_numpy(rng_np.random(
        (n_total, NEG_SAMPLES), dtype=np.float32)).to(device))
    gen = torch.Generator(device=device).manual_seed(13)
    state = {"params": params, "opt": optimizer.init(params),
             "shadow": torch.full((), -1.0, device=device), "start": 0,
             "loss": None}

    def run_chunk():
        (state["params"], state["opt"], state["shadow"], state["loss"],
         _) = runner(state["params"], state["opt"], state["shadow"], gen,
                     features, adj, pairs, negs, state["start"], ITERS,
                     drop_seed=13)
        state["start"] += ITERS
        return state

    return time_chunks(run_chunk, _fetch), edges_per_step(True)


def run_config(name: str, device) -> dict:
    """One config's row: the JAX script's keys, the card's line."""
    agg, size, fused, dist, id_dim, unsup, *extra = CONFIGS[name]
    drop = extra[0] if extra else 0.0
    fn = run_unsupervised if unsup else run_supervised
    t0 = time.perf_counter()
    sec, edges = fn(name, agg, size, fused, dist, id_dim, drop, device=device)
    return {
        "config": name, "aggregator": agg, "model_size": size,
        "fused_gather": fused, "dist": dist, "identity_dim": id_dim,
        "unsupervised": unsup, "dropout": drop,
        "ms_per_step": round(sec * 1e3, 4), "edges_per_step": edges,
        "edges_per_sec": round(edges / sec, 1), "iters_per_chunk": ITERS,
        "trials": TRIALS, "wall_s": round(time.perf_counter() - t0, 1),
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "card": bench.card_line(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.agg_sweep",
        description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*", metavar="config",
                   help="names of CONFIGS")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu")
    p.add_argument("--out", default=OUT_PATH,
                   help="JSON lines file the rows append to")
    args = p.parse_args(argv)
    if not args.configs:
        print("usage: agg_sweep <config> [config ...]; configs:",
              ", ".join(CONFIGS), file=sys.stderr)
        return 2
    unknown = [n for n in args.configs if n not in CONFIGS]
    if unknown:
        p.error(f"unknown configs {unknown}; configs: {', '.join(CONFIGS)}")
    device = resolve_device(args.device)
    for name in args.configs:
        row = run_config(name, device)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as fp:
            fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
