"""Serving throughput on the card: every node's embedding (or, with
``--predict``, its class scores), the port of the JAX package's
``benchmarks/serving_bench.py``.

    python -m graphsage_tpu_torch.benchmarks.serving_bench [--predict]
        [--device cpu]

bench.py's workload (100k nodes, 602 features, zipf(1.05) adjacency from
``default_rng(0)``, fanouts 25/10, dims 128/128, GraphSAGE-mean with the
fused gather-mean, K1, for the innermost hop; weights from torch seed
0). The embed sweep (``train/unsupervised.py::make_embed_sweep``, what
``embed`` and the trainer's export run) or the supervised eval sweep
(``train/supervised.py::make_eval_sweep``, what ``predict`` runs, the
labels from the same generator) covers every node, dummy-padded to
whole batches of 512, with the sampler seeded alike each sweep. One
warm-up sweep, then the best of TRIALS, each ended by reading one
element back; the copy of the whole result to the host is not timed.
Prints one JSON line with the JAX script's keys and the card's name
and power limit. The JAX script's TPU preflight does not carry over.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from graphsage_tpu_torch.benchmarks import bench
from graphsage_tpu_torch.device import resolve_device

TRIALS = 3


def make_sweep(predict: bool, device):
    """(sweep(generator) -> [n_b*B, out] rows on the device, the padded
    node count)."""
    rng = np.random.default_rng(0)
    features = torch.from_numpy(bench.feature_table(rng)).to(device)
    adj = torch.from_numpy(bench.zipf_adjacency(rng)).to(device)
    ids_all = bench.padded_node_stream(device)
    sage = bench.sage_config(True)
    if predict:
        from graphsage_tpu_torch.models.supervised import (
            SupervisedConfig,
            init_supervised_params,
        )
        from graphsage_tpu_torch.train.supervised import make_eval_sweep

        config = SupervisedConfig(sage=sage, num_classes=bench.NUM_CLASSES,
                                  sigmoid_loss=False, weight_decay=0.0)
        params = init_supervised_params(torch.Generator().manual_seed(0),
                                        config, device=device)
        labels_table = np.zeros((bench.NUM_NODES + 1, bench.NUM_CLASSES),
                                np.float32)
        labels_table[np.arange(bench.NUM_NODES),
                     rng.integers(0, bench.NUM_CLASSES,
                                  bench.NUM_NODES)] = 1.0
        labels_dev = torch.from_numpy(labels_table).to(device)
        raw = make_eval_sweep(config, bench.BATCH, bench.NUM_NODES)

        def sweep(gen):
            return raw(params, features, adj, ids_all, labels_dev, gen)[1]
    else:
        from graphsage_tpu_torch.models.unsupervised import (
            UnsupervisedConfig,
            init_unsupervised_params,
        )
        from graphsage_tpu_torch.train.unsupervised import make_embed_sweep

        config = UnsupervisedConfig(sage=sage)
        params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                          config, device=device)
        raw = make_embed_sweep(config, bench.BATCH)

        def sweep(gen):
            return raw(params, features, adj, ids_all, gen)
    return sweep, ids_all.shape[0]


def measure(predict: bool, device) -> dict:
    sweep, n_padded = make_sweep(predict, device)

    def run():
        rows = sweep(torch.Generator(device=device).manual_seed(7))
        float(rows[0, 0])   # the completion barrier

    run()                   # warm-up
    best_dt = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        run()
        best_dt = min(best_dt, time.perf_counter() - t0)
    s2, s1 = bench.FANOUTS[1], bench.FANOUTS[0]
    nodes_per_sec = n_padded / best_dt
    return {
        "metric": ("serving_predict_nodes_per_sec" if predict
                   else "serving_embed_nodes_per_sec"),
        "value": round(nodes_per_sec, 1),
        "unit": "nodes/s/chip",
        "edges_per_sec": round(nodes_per_sec * (s2 + s2 * s1), 1),
        "sweep_s": round(best_dt, 4),
        "n_nodes": bench.NUM_NODES,
        "batch_size": bench.BATCH,
        "graph_dist": "zipf",
        "reference": ("none: the reference has no serving surface "
                      "(embeddings only inside a training session, "
                      "unsupervised_train.py:94-117)"),
        "card": bench.card_line(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m graphsage_tpu_torch.benchmarks.serving_bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--predict", action="store_true",
                   help="the supervised eval sweep (predict's path)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:<i> or cpu")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.predict, resolve_device(args.device))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
