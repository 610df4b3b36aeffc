#!/usr/bin/env python3
"""Drive the PyTorch port (graphsage_tpu_torch) on one CUDA card.

    python3 chip_smoke.py           # from the root of a checkout
    python3 chip_smoke.py --loads   # only K1/K3's load probe
                                    # (probe_loads)
    python3 chip_smoke.py --cards 4 # the sharded runners on 4 cards
                                    # (NCCL; sharded_ranks,
                                    # sharded_unsup_ranks)

Phases; any failure exits non-zero without the final ok line:
  1. the card: nvidia-smi's name and power limit; TF32 off, as the
     parity tests' "highest" matmul precision
  2. build the CUDA kernels from the checkout's sources (one nvcc per
     source, all started together); cuobjdump's instruction counts,
     where the toolkit has it: K5/K6's instances at the hop must issue
     tensor-core instructions (HGMMA), K7's bulk copies (UBLKCP) and
     HMMA
  3. each kernel against its plain PyTorch version on the card, at the
     hop's shapes (f32 and bf16) and ragged ones; kernel, plain and
     library-route times beside the kernel's bound. K1 is the
     gather-mean (at the hop through the sampler, as serving draws it,
     and on i.i.d. zipf ids), K2 the gather-mean with Philox dropout
     (identical masks, equal means, the rate's zero fraction, the
     1/keep scale), K3 the gather-mean that loads each distinct sample
     once (at the hop through the sampler, and at S = 1, 31, 32 and
     33, all samples equal, all distinct, rows repeated down the idx,
     F = 17, B = 7 and S at its shared-memory limit), K4 the
     row gather (bit-equal to index_select), K5 the gather -> MLP ->
     pool (mean and max, ties), K6 the same writing its dropped rows as
     the backward's residual (residual bit-equal to the plain dropped
     rows, the mask identical, and the gradients of its autograd
     Function against autograd of the plain composition); K5/K6 against
     the 3xTF32 bound, with one cuBLAS product in a single TF32 pass
     beside them as an informational floor. K7, the gather-mean probe's
     kernels (gather_probe.cu: K7a's bulk-copy ring with per-sample,
     per-row and per-tile waits, its hot and compacted modes, K7b's
     counts @ bf16 hot block, K7c's 2xTF32 counts @ hot rows with the
     cold ring), at the probe's shape (N 100k, F 640, B 1024, S 25),
     zipf and uniform ids, K 1024 and 4096, timed beside K1,
     index_select + mean and embedding_bag. K1 and K3 also at the
     unsupervised model's hop, idx [10440, 25] from the sampler over
     the three towers' ids (2 x 512 pairs' ends and 20 negatives), K2
     there too (rate 0.5, masks identical)
  4. serving at full width, bench.py's model: 100k nodes, 602 features,
     41 classes, fanouts 25/10, dims 128/128, batch 512, zipf(1.05)
     adjacency, seeded random weights. The eval sweep answers every node
     (196 requests of 512) with GraphSAGE-mean (K1 once per batch), with
     GraphSAGE-mean and dedup_gather (K3 once per batch, no K1), with
     GraphSAGE-meanpool, MLP hidden width 512 (K5 once per batch) and
     with GraphSAGE-seq, LSTM hidden width 128, and rows_gather (K4 once
     per batch). Checks the predictions and their agreement with the
     path without the kernel (K3: with the K1 sweep), then times
     requests one by one and profiles 20 batches. A few batches of
     GraphSAGE-maxpool with rows_gather (K4) against the plain gather
  5. training at full width: the same models and data with dropout 0.5
     and Adam at lr 1e-2 (benchmarks/agg_sweep.py's "mean_drop" and
     "meanpool_fused_drop"), through the chunk runner: timed chunks of
     50 steps (s/step, edges/s), K2 (mean) or K6 (meanpool) once per
     step, the loss finite at every chunk end, the host
     synchronisations per step, and a profile of a few steps; and
     GraphSAGE-seq with rows_gather, dropout 0 (agg_sweep.py's "seq"),
     K4 once per step, in shorter chunks
     Unsupervised GraphSAGE-mean at the same width
     (benchmarks/agg_sweep.py's "unsup_mean": 20 negatives from a
     uniform CDF over the N+1 ids, uniform pairs from numpy seed 5,
     Adam at lr 1e-5, dropout 0): three timed chunks of 50 steps
     (ms/step, edges/s over the three towers), K1 once per step, the
     loss finite and the train MRR and its EMA in (0, 1] at every chunk
     end, no host synchronisation in a chunk, a profile of 5 steps. The
     embed sweep (bench.py's and benchmarks/serving_bench.py's
     workload): every node's l2-normalised embedding, 196 batches of
     512, K1 once per batch, within 1e-5 of the sweep without the
     kernel, unit rows; requests one at a time, a profile of 20 batches.
     The slice's other routes, 4 launches each: K2 (mean) and K6
     (meanpool) in unsupervised training at dropout 0.5, after one step
     through each is held to the plain path with the same drop key
     (loss and gradients), K5 in the meanpool embed sweep (against the
     sweep without it)
     The C++ host builder (graph_builder.cpp, g++) on bench.py's graph
     (its zipf adjacency made undirected, 70% train nodes): both padded
     adjacencies and 10 walks of length 5 from every train node, timed,
     pairs/s beside the Python walker's on 2,000 nodes; fails if a NumPy
     path ran. node2vec at full width on those pairs (dim 256, batch
     512, 20 unique negatives from host Gumbel noise, SGD at lr 2.0):
     three timed chunks of 50 steps (ms/step, pairs/s), no kernel of
     K1-K7 and no host synchronisation in a chunk, a profile of 5 steps,
     two retrain chunks with every frozen context row bit-identical, one
     step against the CPU (loss and gradients within 1e-5), the first
     chunk's negatives equal on the card and the CPU. ``eval``'s
     classifier at Reddit's scale on its target rows (~70k train rows of
     256, 41 planted classes, 2 fixed epochs; ``run_regression``) on the
     card and the CPU: us per sample update, F1s within 1e-3 (rounding
     alone moves them: the CPU against itself with X moved by 1e-15 is
     logged beside), a profile
     The graph-sharded stack (``parallel/graph_sharded.py``) at the same
     width: on a world-size-1 NCCL group in this process, the sharded
     chunk runner against the single-device runner (first_k, dropout 0:
     equal losses, bit-equal params), three timed chunks of 50 steps at
     dropout 0.5 (K2 once per step, no request dropped), and the sharded
     eval sweep over every node (K1 once per batch, the single-device
     sweep's predictions; with dedup_gather K3 once per batch); then two
     gloo ranks spawned on this one card (``parallel/launch.py``), the
     exchange and the split mean on the card, held to the single-device
     runner at the JAX tests' tolerances, then 4 steps at dropout 0.5
     (finite losses, params bit-equal across the ranks, nothing
     dropped). The unsupervised half at "unsup_mean"'s width: on a
     world-size-1 NCCL group, the sharded unsupervised runner against
     the single-device runner (first_k, dropout 0: equal losses and
     MRRs, bit-equal params), three timed chunks of 50 steps (K1 once
     per step at the [10440, 25] hop, nothing dropped, no host
     synchronisation in a chunk, ms/step beside the single-device
     cell's), 4 steps at dropout 0.5 (K2 once per step), the sharded
     embed sweep over every node (K1 once per batch, embed_all_nodes'
     rows bit for bit; with dedup_gather K3 once per batch; nodes/s and
     request latency beside the single-device sweep's) and the sharded
     eval sweep (the single-device sweep's loss and MRR); then two gloo
     ranks on this card, 1 x 2 (data-parallel, held to the single-device
     runner) and 2 x 1 (each rank its own negatives, held to a
     reference built on one device from those negatives). And
     ``supervised --graph_shards 2`` and ``unsupervised --graph_shards
     2``, which must refuse this one-card machine, naming the two
     devices they need
  6. fused vs unfused training at dropout 0 (K1, K6, K4 or K3 against
     the plain gather): equal gradients and params after a few steps
     from the same state; the same for unsupervised training (K1, K6)
     with the same pairs and negatives, mean's params held per element
     where Adam's sqrt(v) stays above 1e3 eps, the worst element's
     gradient and sqrt(v) logged
  7. the CLI on the card against the CPU, the card-side processes
     started together: ``python -m graphsage_tpu_torch predict`` (and
     with ``--dedup_gather``) on a small synthetic dataset from a port
     checkpoint, and ``supervised`` (graphsage_mean, graphsage_meanpool,
     graphsage_seq with --rows_gather) with first_k sampling and dropout
     0: the predictions, every logged train loss and the final val loss
     agree. ``walks`` writes the walk pairs (on the host), then
     ``unsupervised`` (graphsage_mean, graphsage_meanpool) trains on
     them with first_k sampling and dropout 0: every logged loss, MRR
     and EMA agrees with the CPU's, val.npy within 1e-4, and ``embed``
     from the card run's checkpoint reproduces its val.npy bit for bit.
     ``unsupervised --model n2v --save_embeddings``: every logged loss,
     MRR and EMA within 1e-4 of the CPU's, val.npy and val-test.npy
     within 1e-5; then ``eval`` of the card run's embeddings on the card
     and on the CPU prints the same F1s. ``supervised --degree_relabel
     --defer_features --log_histograms --profile_dir``: the losses agree
     with the CPU's, both write their histograms, and the card's trace
     names the gather-mean kernel
  8. the probe's entry point (python -m
     graphsage_tpu_torch.benchmarks.gather_probe), zipf ids, short
     trials: it exits 0 and launches every K7 instance and K1 and
     nothing else (the launches of the kernels line)
  9. one JSON line of per-kernel numbers, then the ok line (last)

Needs no network and one card; builds into build/kernels/.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_NODES = 100_000
FEAT_DIM = 602
NUM_CLASSES = 41
MAX_DEGREE = 128
BATCH = 512
FANOUTS = (25, 10)
DIMS = (128, 128)
HOP_ROWS = BATCH * FANOUTS[1]          # 5120 rows of the innermost hop
HBM_BYTES_PER_S = 3.35e12              # H100 SXM device memory
F32_OPS_PER_S = 67e12                  # H100 SXM f32, outside tensor cores
TF32_OPS_PER_S = 495e12                # H100 SXM TF32 tensor cores, dense
# H100 SXM int32: 132 SMs x 64 lanes x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K2's integer instructions per element, counted from its source: one
# Philox4x32-10 call per 4 elements = 10 rounds x (2 32x32->64 multiplies
# + 2 three-input XORs) = 40 (the key schedule is warp-uniform), plus
# one compare per element
K2_INT_OPS_PER_ELEM = 40 / 4 + 1
K2_F32_OPS_PER_ELEM = 2                # scale multiply, add
F32_TOL = 1e-5                         # max abs error, kernel vs plain
# K5/K6 vs plain: z is a sum of F = 602 f32 products, taken by the kernel
# in one fma chain per output and by cuBLAS in another order
POOL_TOL = 5e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX suite's, test_pool.py:70
POOL_HIDDEN = 512                      # nn/aggregators.py, "small"
# K7 vs plain, max abs error: both sum the same f32 (or bf16-exact)
# values in f32, in other orders; K7c's hot rows in 2xTF32 (~2^-22
# relative); K7b and its plain version multiply the same bf16 block
PROBE_TOL = 1e-5
DROPOUT = 0.5             # agg_sweep.py's "mean_drop", "meanpool_fused_drop"
LEARNING_RATE = 1e-2
EDGES_PER_STEP = BATCH * (FANOUTS[1] + FANOUTS[1] * FANOUTS[0])  # 133120
TRAIN_CHUNK = 50                       # steps per timed chunk
SEQ_TRAIN_CHUNK = 10      # the seq cell's chunks: ~10x the device work
CLI_TOL = 1e-4                         # card vs CPU training losses
NEG_SAMPLES = 20                       # agg_sweep.py's "unsup_mean"
UNSUP_LR = 1e-5
ADAM_FLOOR = 1e3          # x eps: sqrt(v) above it, Adam keeps dg small
UNSUP_HOP_ROWS = (2 * BATCH + NEG_SAMPLES) * FANOUTS[1]    # 10440
N2V_DIM = 2 * DIMS[0]     # the trainer's 2 x dim_1
N2V_LR = 2.0              # benchmarks/accuracy_acceptance.py:275
N2V_TOL = 1e-5            # node2vec loss and gradients, card vs CPU
EVAL_EPOCHS = 2           # eval at full width: fixed SGD epochs
# eval at full width, card vs CPU: F1 differences of at most 1e-3 (0.1%
# of the rows predicted otherwise). SGD's first steps, at eta ~10, grow a
# last-bit difference until a few rows turn, so no two float64 fits that
# sum in other orders predict every row alike; the phase logs the CPU
# against itself with X moved by 1e-15 beside it
EVAL_F1_TOL = 1e-3
# three towers' roots, each expanded S2 + S2*S1 (agg_sweep.py:263-265)
UNSUP_EDGES_PER_STEP = (2 * BATCH + NEG_SAMPLES) * (
    FANOUTS[1] + FANOUTS[1] * FANOUTS[0])                  # 271440
ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# K7's instances: (count key, JSON name, the TPU kernel it replaces)
K7_INSTANCES = (
    ("K7a.sample", "probe_gather_sample", "benchmarks/gather_probe.py:65"),
    ("K7a.row", "probe_gather_row", "benchmarks/gather_probe.py:111"),
    ("K7a.tile", "probe_gather_tile", "benchmarks/gather_probe.py:161"),
    ("K7a.hot", "probe_gather_hot", "benchmarks/gather_probe.py:202"),
    ("K7a.compacted", "probe_coldsw", "benchmarks/gather_probe.py:371"),
    ("K7b", "probe_hotcount", "benchmarks/gather_probe.py:443"),
    ("K7c", "probe_hotmx", "benchmarks/gather_probe.py:275"),
)
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6") + tuple(
    key for key, _, _ in K7_INSTANCES)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from graphsage_tpu_torch.ops import gather_probe as pr
    from graphsage_tpu_torch.ops.gather import fused_gather_mean as gm
    from graphsage_tpu_torch.ops.gather import fused_gather_rows as gr
    from graphsage_tpu_torch.ops.pool import fused_gather_mlp_pool as gp

    counts = {"K1": gm.launches, "K2": gm.dropout_launches,
              "K3": gm.dedup_launches, "K4": gr.launches, "K5": gp.launches,
              "K6": gp.train_launches}
    counts.update({f"K7a.{w}": n for w, n in pr.probe_gather.launches.items()})
    counts.update({"K7a.hot": pr.probe_gather_hot.launches,
                   "K7a.compacted": pr.probe_coldsw.launches,
                   "K7b": pr.probe_hotcount.launches,
                   "K7c": pr.probe_hotmx.launches})
    return counts


def reset_counts() -> None:
    from graphsage_tpu_torch.ops import gather_probe as pr
    from graphsage_tpu_torch.ops.gather import fused_gather_mean as gm
    from graphsage_tpu_torch.ops.gather import fused_gather_rows as gr
    from graphsage_tpu_torch.ops.pool import fused_gather_mlp_pool as gp

    gm.launches = gm.dropout_launches = gm.dedup_launches = 0
    gr.launches = 0
    gp.launches = gp.train_launches = 0
    pr.probe_gather.launches = dict.fromkeys(pr.probe_gather.launches, 0)
    pr.probe_gather_hot.launches = pr.probe_coldsw.launches = 0
    pr.probe_hotcount.launches = pr.probe_hotmx.launches = 0


def check_counts(counts: dict, kernel: str, n: int, what: str) -> None:
    """``kernel`` launched ``n`` times in ``what``, every other none."""
    want = {k: (n if k == kernel else 0) for k in KERNELS}
    check(counts == want, f"{what}: launches {counts}, expected {want}")


def cycling(fn, idx_sets):
    """A call of ``fn`` on the next idx set, round the list: repeated
    timing launches then find no more of one set's rows in L2 than a
    sweep would."""
    state = {"i": 0}

    def call():
        fn(idx_sets[state["i"] % len(idx_sets)])
        state["i"] += 1
    return call


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events. The
    timed calls queue up behind a spin kernel, so the host's per-call
    launch overhead does not pace the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # ~10 ms of device clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def zipf_ids(rng, size, alpha: float = 1.05) -> np.ndarray:
    """Node ids drawn zipf over degree-ordered ids (id 0 is the biggest
    hub), as bench.py draws its adjacency."""
    p = np.arange(1, NUM_NODES + 1, dtype=np.float64) ** -alpha
    return rng.choice(NUM_NODES, size=size, p=p / p.sum()).astype(np.int32)


# ------------------------------------------------------------ phase 1

def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 3

def gather_bytes_ms(idx, F: int = FEAT_DIM, elem: int = 4) -> float:
    """The bytes bound of a gather-mean over ``idx`` [B, S] into a table
    of F columns of ``elem`` bytes (bench.py's f32 table by default):
    each distinct row read once, the [B, F] f32 output written once, the
    ids read once, at the card's memory rate."""
    distinct = int(idx.unique().numel())
    n_bytes = (distinct * F * elem + idx.shape[0] * F * 4
               + idx.numel() * 4)
    return n_bytes / HBM_BYTES_PER_S * 1e3


def tile_distinct(idx, rows: int) -> float:
    """Mean share of distinct ids among the samples of a tile of ``rows``
    consecutive output rows of ``idx``."""
    ids = idx.cpu().numpy()
    shares = [len(np.unique(ids[r:r + rows])) / ids[r:r + rows].size
              for r in range(0, ids.shape[0], rows)]
    return float(np.mean(shares))


def check_gather_mean(dev, card_line: str, data) -> dict:
    """K1 against its plain version (f32 and bf16 tables) at the hop, its
    idx from the sampler over bench.py's zipf adjacency as serving draws
    it, on i.i.d. zipf ids and at ragged widths; its times and bound at
    the hop (the kernels line), then on the i.i.d. ids (a second line)."""
    import torch
    import torch.nn.functional as fnn

    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_reference,
    )

    features = data[0]
    table_bf16 = features.to(torch.bfloat16)
    # several idx sets, cycled, so that repeated timing launches do not
    # find one set's rows in L2 more often than a sweep would
    hop_sets = hop_idx_sets(dev, data, 8, seed=10)
    rng = np.random.default_rng(1)
    zipf_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                 .to(dev) for _ in range(8)]

    err = {"f32": 0.0, "bf16": 0.0}

    def compare(tab, idx):
        name = "f32" if tab.dtype == torch.float32 else "bf16"
        out = fused_gather_mean(tab, idx)
        ref = gather_mean_reference(tab, idx)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"gather_mean {name}: bad output")
        err[name] = max(err[name], float((out - ref).abs().max()))
        return out

    for idx in hop_sets[:2] + zipf_sets[:2]:
        compare(features, idx)
        compare(table_bf16, idx)
    gen = torch.Generator(device=dev).manual_seed(0)
    for F in (1, 3, 17, 602, 640):
        small = torch.randn(65, F, generator=gen, device=dev)
        small[64] = 0
        cases = [torch.full((1, 1), 64, dtype=torch.int32, device=dev),
                 torch.randint(0, 65, (3, 5), generator=gen, device=dev,
                               dtype=torch.int32)]
        for idx in cases:
            compare(small, idx)
            compare(small.to(torch.bfloat16), idx)
        check(bool((fused_gather_mean(small, cases[0]) == 0).all()),
              f"gather_mean: the dummy row did not give zeros at F={F}")
    torch.cuda.synchronize()
    log(f"gather_mean vs plain (the hop, i.i.d. zipf ids, F 1-640): max "
        f"abs err f32 {err['f32']:.3e}, bf16 table {err['bf16']:.3e} "
        f"(limit {F32_TOL})")
    check(max(err.values()) <= F32_TOL,
          f"gather_mean error {max(err.values())} > {F32_TOL}")

    def timed(idx_sets, what):
        ms = cuda_ms(cycling(lambda idx: fused_gather_mean(features, idx),
                             idx_sets))
        plain_ms = cuda_ms(cycling(
            lambda idx: gather_mean_reference(features, idx), idx_sets))
        library_ms = cuda_ms(cycling(
            lambda idx: fnn.embedding_bag(idx, features, mode="mean"),
            idx_sets))
        bf16_ms = cuda_ms(cycling(
            lambda idx: fused_gather_mean(table_bf16, idx), idx_sets))
        bytes_ms = float(np.mean([gather_bytes_ms(i) for i in idx_sets]))
        n_ops = HOP_ROWS * FANOUTS[0] * FEAT_DIM + HOP_ROWS * FEAT_DIM
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        distinct = np.mean([int(i.unique().numel()) for i in idx_sets])
        log(f"gather_mean at {what}, idx [{HOP_ROWS},{FANOUTS[0]}] into "
            f"[{NUM_NODES + 1},{FEAT_DIM}] f32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, embedding_bag {library_ms:.4f} ms, bf16 "
            f"table {bf16_ms:.4f} ms; {distinct:.0f} distinct rows per "
            f"launch; bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, ops "
            f"{ops_ms:.4f}); bound share {bound_ms / ms:.3f}; on "
            f"{card_line}")
        return {
            "name": "gather_mean",
            "route": "cuda",
            "source": "graphsage_tpu_torch/ops/csrc/gather_mean.cu",
            "replaces": "graphsage_tpu/ops/gather.py:160",
            "launches": None,
            "max_abs_err": max(err.values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
        }

    entry = timed(hop_sets, "the sampler's hop idx")
    timed(zipf_sets, "i.i.d. zipf(1.05) ids")
    return entry


def probe_loads(dev, card_line: str, data) -> None:
    """``--loads``: K1 and K3 at the hop (the sampler's idx) at each load
    width the wrapper picks: 8 bytes on the f32 table, 4 on the same
    table one element off a 16-byte boundary, 4 on its bf16 copy and 16
    on a [N+1, 640] f32 table; each held to its plain version before it
    is timed. Then K1 on ids that isolate the load path's parts: the
    hop's rows left in L2, every load an L1 hit, L2-resident rows with
    little reuse, rows from device memory. Writes every result to
    chiprun_out/loads.json."""
    import torch

    from graphsage_tpu_torch.ops import gather as g

    features = data[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    shifted = torch.empty(features.numel() + 1, device=dev)[1:]
    shifted.copy_(features.reshape(-1))
    tables = {
        "f32 602": features,
        "f32 602, one element off": shifted.view(features.shape),
        "bf16 602": features.to(torch.bfloat16),
        "f32 640": torch.randn(NUM_NODES + 1, 640, generator=gen,
                               device=dev),
    }
    idx_sets = hop_idx_sets(dev, data, 8, seed=10)
    results = []
    log(f"K1/K3 load widths at idx [{HOP_ROWS},{FANOUTS[0]}] from the "
        f"sampler; on {card_line}")
    for name, table in tables.items():
        F, elem = table.shape[1], table.element_size()
        load_bytes = g._vector_width(F, elem, table.data_ptr(), 0) * elem
        bytes_ms = float(np.mean([gather_bytes_ms(i, F, elem)
                                  for i in idx_sets]))
        for dedup in (False, True):
            plain = (g.gather_mean_dedup_reference if dedup
                     else g.gather_mean_reference)
            out = g.fused_gather_mean(table, idx_sets[0], dedup=dedup)
            err = float((out - plain(table, idx_sets[0])).abs().max())
            kernel = f"K{3 if dedup else 1}"
            check(err <= F32_TOL, f"{kernel} {name}: error {err}")
            ms = cuda_ms(cycling(lambda idx: g.fused_gather_mean(
                table, idx, dedup=dedup), idx_sets))
            log(f"  {kernel} {name}: {load_bytes}-byte loads: {ms:.4f} ms, "
                f"bound {bytes_ms:.4f} ms, share {bytes_ms / ms:.3f}, err "
                f"{err:.2e}")
            results.append({"kernel": kernel, "table": name,
                            "load_bytes": load_bytes, "ms": ms,
                            "bound_ms": bytes_ms, "max_abs_err": err})

    # what sets K1's pace: K1 on ids that isolate the load path's parts,
    # same shape, the f32 table
    rng = np.random.default_rng(4)

    def ids(make):
        return [torch.from_numpy(np.ascontiguousarray(make(), dtype=np.int32))
                .to(dev) for _ in range(8)]

    shape = (HOP_ROWS, FANOUTS[0])
    dists = {
        "the hop, 8 idx sets (as timed above)": idx_sets,
        "the hop, 1 idx set (its rows stay in L2)": idx_sets[:1],
        "every sample row 0 (each load an L1 hit)":
            ids(lambda: np.zeros(shape))[:1],
        "uniform over 1k rows (L2-resident, little L1 reuse)":
            ids(lambda: rng.integers(0, 1000, shape)),
        "uniform over 100k rows (device memory)":
            ids(lambda: rng.integers(0, NUM_NODES, shape)),
    }
    by_ids = {}
    for name, sets in dists.items():
        ms = cuda_ms(cycling(lambda idx: g.fused_gather_mean(features, idx),
                             sets))
        log(f"  K1 f32 602 on {name}: {ms:.4f} ms, "
            f"{HOP_ROWS * FANOUTS[0] * FEAT_DIM * 4 / ms / 1e9:.2f} TB/s "
            f"of gathered rows")
        by_ids[name] = ms
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "loads.json"), "w") as f:
        json.dump({"card": card_line, "results": results,
                   "k1_ms_by_ids": by_ids}, f, indent=1)


def check_gather_mean_dropout(dev, card_line: str) -> dict:
    """K2 against its plain version under the same seed, step and tag;
    its statistics at rate 0.5; its times and bounds at the hop."""
    import torch

    from graphsage_tpu_torch.models.graphsage import KERNEL_DROP_TAG
    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_dropout_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn(NUM_NODES + 1, FEAT_DIM, generator=gen, device=dev)
    table[NUM_NODES] = 0
    rng = np.random.default_rng(3)
    idx_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                .to(dev) for _ in range(8)]
    key = dict(seed=0x0123456789ABCDEF, offset=(17, KERNEL_DROP_TAG))

    err = {}
    for name, tab in (("f32", table), ("bf16", table.to(torch.bfloat16))):
        idx = idx_sets[0]
        out = fused_gather_mean(tab, idx, DROPOUT, **key)
        ref = gather_mean_dropout_reference(tab, idx, DROPOUT, **key)
        err[name] = float((out - ref).abs().max())
        # the mask itself: one sample per row, the same elements
        flat = idx.reshape(-1, 1)
        got = fused_gather_mean(tab, flat, DROPOUT, **key) == 0
        want = gather_mean_dropout_reference(tab, flat, DROPOUT, **key) == 0
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"K2 {name}: {n_diff} mask elements differ")
        check(err[name] <= F32_TOL,
              f"K2 {name} error {err[name]} > {F32_TOL}")
        del got, want, out, ref
    log(f"K2 vs plain at idx [{HOP_ROWS},{FANOUTS[0]}]: masks identical "
        f"({HOP_ROWS * FANOUTS[0] * FEAT_DIM} elements, f32 and bf16 "
        f"tables); max abs err f32 {err['f32']:.3e}, bf16 {err['bf16']:.3e} "
        f"(limit {F32_TOL})")

    ones = torch.ones(64, FEAT_DIM, device=dev)
    s1 = torch.from_numpy(rng.integers(0, 64, (HOP_ROWS, 1),
                                       dtype=np.int32)).to(dev)
    out = fused_gather_mean(ones, s1, DROPOUT, **key)
    zero_frac = float((out == 0).float().mean())
    kept = out[out != 0]
    scale_ok = bool((kept == float(np.float32(1 / (1 - DROPOUT)))).all())
    other = fused_gather_mean(ones, s1, DROPOUT, seed=key["seed"],
                              offset=(18, KERNEL_DROP_TAG))
    steps_differ = not torch.equal(out == 0, other == 0)
    log(f"K2 at rate {DROPOUT}, all-ones table, S=1, {out.numel()} "
        f"elements: zero fraction {zero_frac:.5f} (limit +-0.005), kept "
        f"values all 1/keep: {scale_ok}, step 17 vs 18 masks differ: "
        f"{steps_differ}")
    check(abs(zero_frac - DROPOUT) <= 0.005, f"K2 zero fraction {zero_frac}")
    check(scale_ok, "K2 kept values are not 1/keep")
    check(steps_differ, "K2 gave the same mask for two steps")

    ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(table, idx, DROPOUT, **key), idx_sets))
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mean_dropout_reference(table, idx, DROPOUT,
                                                  **key), idx_sets),
        iters=5, warmup=1)
    table_bf16 = table.to(torch.bfloat16)
    bf16_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(table_bf16, idx, DROPOUT, **key),
        idx_sets))

    elements = HOP_ROWS * FANOUTS[0] * FEAT_DIM
    bytes_ms = float(np.mean([gather_bytes_ms(idx) for idx in idx_sets]))
    int_ms = elements * K2_INT_OPS_PER_ELEM / INT32_OPS_PER_S * 1e3
    f32_ms = elements * K2_F32_OPS_PER_ELEM / F32_OPS_PER_S * 1e3
    ops_ms = max(int_ms, f32_ms)
    bound_ms = max(bytes_ms, ops_ms)
    log(f"K2 at idx [{HOP_ROWS},{FANOUTS[0]}] into [{NUM_NODES + 1},"
        f"{FEAT_DIM}] f32, rate {DROPOUT}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bf16 table {bf16_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f}; int32 {int_ms:.4f} at "
        f"{K2_INT_OPS_PER_ELEM:g} per element and {INT32_OPS_PER_S:.4g}/s; "
        f"f32 {f32_ms:.4f}); bound share {bound_ms / ms:.3f}; library: none "
        f"(no single PyTorch call draws a per-element mask inside a "
        f"gather-mean); on {card_line}")
    return {
        "name": "gather_mean_dropout",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mean.cu",
        "replaces": "graphsage_tpu/ops/gather.py:136",
        "launches": None,
        "max_abs_err": max(err.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def hop_idx_sets(dev, data, n_sets: int, seed: int) -> list:
    """``n_sets`` innermost-hop idx [5120, 25] of bench.py's model, each
    from a batch of 512 distinct nodes through the sampler
    (``shared_perm``) over the zipf adjacency, as serving draws them."""
    import torch

    from graphsage_tpu_torch.models.graphsage import sample_frontier

    _, adj, _ = data
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sets):
        ids = torch.from_numpy(rng.choice(NUM_NODES, BATCH, replace=False)
                               .astype(np.int32)).to(dev)
        samples = sample_frontier(gen, adj, ids, FANOUTS, mode="shared_perm")
        out.append(samples[-1].reshape(HOP_ROWS, FANOUTS[0]).contiguous())
    return out


def check_gather_mean_dedup(dev, card_line: str, data) -> dict:
    """K3 against its plain version (f32 and bf16 tables) at the hop, its
    idx from the sampler over bench.py's zipf adjacency, and at ragged
    shapes; beside it K1 on the same idx; times, bound and the distinct
    share of an output row and of a tile."""
    import torch
    import torch.nn.functional as fnn

    from graphsage_tpu_torch.ops.gather import (
        MAX_DEDUP_SAMPLES,
        dedup_compact,
        fused_gather_mean,
        gather_mean_dedup_reference,
    )

    features = data[0]
    table_bf16 = features.to(torch.bfloat16)
    idx_sets = hop_idx_sets(dev, data, 8, seed=20)
    err = {}

    def compare(name, tab, idx):
        out = fused_gather_mean(tab, idx, dedup=True)
        ref = gather_mean_dedup_reference(tab, idx)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"K3 {name}: bad output")
        err[name] = max(err.get(name, 0.0), float((out - ref).abs().max()))
        return out

    k1_diff = 0.0
    for idx in idx_sets[:2]:
        out = compare("hop f32", features, idx)
        k1_diff = max(k1_diff, float(
            (out - fused_gather_mean(features, idx)).abs().max()))
        compare("hop bf16", table_bf16, idx)
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 4000

    def randint(B, S):
        return torch.randint(0, n, (B, S), generator=gen, device=dev,
                             dtype=torch.int32)

    ragged = {
        "S=1": (randint(7, 1), FEAT_DIM),
        "all equal": (randint(5, 1).expand(5, FANOUTS[0]).contiguous(),
                      FEAT_DIM),
        "all distinct": (torch.stack([
            torch.randperm(n, generator=gen, device=dev)[:FANOUTS[0]]
            for _ in range(5)]).to(torch.int32), FEAT_DIM),
        "F=17": (randint(9, FANOUTS[0]), 17),
        "B=7": (randint(7, FANOUTS[0]), FEAT_DIM),
        "S=31": (randint(40, 31), FEAT_DIM),
        "S=32": (randint(40, 32), FEAT_DIM),
        "S=33": (randint(40, 33), FEAT_DIM),
        # 8 distinct rows, each repeated 9 times down the idx
        "rows repeated": (randint(8, FANOUTS[0]).repeat(9, 1), FEAT_DIM),
        f"S={MAX_DEDUP_SAMPLES}": (randint(3, MAX_DEDUP_SAMPLES), 33),
    }
    for name, (idx, F) in ragged.items():
        tab = torch.randn(n, F, generator=gen, device=dev)
        compare(name, tab, idx)
        compare(name + " bf16", tab.to(torch.bfloat16), idx)
    n_u_one = int(dedup_compact(ragged["all equal"][0])[1].max())
    torch.cuda.synchronize()
    worst = max(err.values())
    log("K3 vs plain, max abs err: " + ", ".join(
        f"{k} {v:.3e}" for k, v in err.items()) + f" (limit {F32_TOL}); K3 "
        f"vs K1 at the hop {k1_diff:.3e}; n_u of the all-equal rows "
        f"{n_u_one}")
    check(worst <= F32_TOL, f"K3 error {worst} > {F32_TOL}")
    check(k1_diff <= F32_TOL, f"K3 and K1 differ by {k1_diff}")
    check(n_u_one == 1, "dedup_compact: all-equal rows not one value")

    ms = cuda_ms(cycling(lambda idx: fused_gather_mean(features, idx,
                                                       dedup=True),
                         idx_sets))
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mean_dedup_reference(features, idx), idx_sets),
        iters=10, warmup=1)
    library_ms = cuda_ms(cycling(
        lambda idx: fnn.embedding_bag(idx, features, mode="mean"), idx_sets))
    k1_ms = cuda_ms(cycling(lambda idx: fused_gather_mean(features, idx),
                            idx_sets))
    bf16_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(table_bf16, idx, dedup=True),
        idx_sets))
    per_row = [float(dedup_compact(idx)[1].float().mean())
               for idx in idx_sets]
    # what rows shared across a tile of T would save (T = 1 ships)
    per_tile = {T: float(np.mean([tile_distinct(idx, T)
                                  for idx in idx_sets[:2]]))
                for T in (2, 8, 32)}
    bytes_ms = float(np.mean([gather_bytes_ms(idx) for idx in idx_sets]))
    ops_ms = float(np.mean([2 * n_u * HOP_ROWS * FEAT_DIM  # w * row, add
                            for n_u in per_row])) / F32_OPS_PER_S * 1e3
    distinct = np.mean([int(idx.unique().numel()) for idx in idx_sets])
    log(f"K3 at idx [{HOP_ROWS},{FANOUTS[0]}] from the sampler into "
        f"[{NUM_NODES + 1},{FEAT_DIM}] f32: kernel {ms:.4f} ms (bf16 table "
        f"{bf16_ms:.4f}), plain {plain_ms:.4f} ms, embedding_bag "
        f"{library_ms:.4f} ms, K1 on the same idx {k1_ms:.4f} ms; distinct "
        f"rows per output row {np.mean(per_row):.3f} of {FANOUTS[0]} (min "
        f"{min(per_row):.3f}, max {max(per_row):.3f} over "
        f"{len(idx_sets)} launches), distinct share of a tile of 2, 8, 32 "
        f"rows " + ", ".join(f"{v:.3f}" for v in per_tile.values())
        + f"; {distinct:.0f} distinct rows per launch; "
        f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, ops "
        f"{ops_ms:.4f}); bound share {max(bytes_ms, ops_ms) / ms:.3f}, K1's "
        f"{max(bytes_ms, ops_ms) / k1_ms:.3f}; on {card_line}")
    return {
        "name": "gather_mean_dedup",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mean.cu",
        "replaces": "graphsage_tpu/ops/gather.py:200",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def unsup_hop_idx_sets(dev, data, n_sets: int, seed: int) -> list:
    """``n_sets`` innermost-hop idx [10440, 25] of the unsupervised
    model: the three towers' ids (512 uniform pairs' two ends, then 20
    uniform negatives) through the sampler (``shared_perm``) over the
    zipf adjacency, as a training step draws them."""
    import torch

    from graphsage_tpu_torch.models.graphsage import sample_frontier

    _, adj, _ = data
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sets):
        ids = torch.from_numpy(np.concatenate([
            rng.integers(0, NUM_NODES, 2 * BATCH),
            rng.integers(0, NUM_NODES + 1, NEG_SAMPLES)]).astype(np.int32)
        ).to(dev)
        samples = sample_frontier(gen, adj, ids, FANOUTS, mode="shared_perm")
        out.append(samples[-1].reshape(UNSUP_HOP_ROWS, FANOUTS[0])
                   .contiguous())
    return out


def check_unsup_hop(dev, card_line: str, data) -> dict:
    """K1, K3 and K2 (rate 0.5: the masks identical too) at the
    unsupervised model's hop against their plain versions (f32 table),
    and K1's and K3's times beside the bound; returns K1's time and
    bound there."""
    import torch

    from graphsage_tpu_torch.models.graphsage import KERNEL_DROP_TAG
    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_dedup_reference,
        gather_mean_dropout_reference,
        gather_mean_reference,
    )

    features = data[0]
    idx_sets = unsup_hop_idx_sets(dev, data, 8, seed=30)
    err = {}
    for dedup, ref in ((False, gather_mean_reference),
                       (True, gather_mean_dedup_reference)):
        for idx in idx_sets[:2]:
            out = fused_gather_mean(features, idx, dedup=dedup)
            check(bool(torch.isfinite(out).all()), "unsup hop: bad output")
            err[dedup] = max(err.get(dedup, 0.0), float(
                (out - ref(features, idx)).abs().max()))
    key = dict(seed=0x0123456789ABCDEF, offset=(17, KERNEL_DROP_TAG))
    idx = idx_sets[0]
    err["K2"] = float((fused_gather_mean(features, idx, DROPOUT, **key)
                       - gather_mean_dropout_reference(
                           features, idx, DROPOUT, **key)).abs().max())
    # the mask itself: one sample per row, the same elements
    flat = idx.reshape(-1, 1)
    n_diff = int(((fused_gather_mean(features, flat, DROPOUT, **key) == 0)
                  != (gather_mean_dropout_reference(
                      features, flat, DROPOUT, **key) == 0)).sum())
    check(n_diff == 0, f"K2 at the unsupervised hop: {n_diff} mask "
          f"elements differ")
    torch.cuda.synchronize()
    check(max(err.values()) <= F32_TOL,
          f"K1/K3/K2 at the unsupervised hop: error {err} > {F32_TOL}")
    ms = cuda_ms(cycling(lambda idx: fused_gather_mean(features, idx),
                         idx_sets))
    k3_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mean(features, idx, dedup=True), idx_sets))
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mean_reference(features, idx), idx_sets))
    bytes_ms = float(np.mean([gather_bytes_ms(idx) for idx in idx_sets]))
    ops_ms = (UNSUP_HOP_ROWS * (FANOUTS[0] + 1) * FEAT_DIM / F32_OPS_PER_S
              * 1e3)
    bound_ms = max(bytes_ms, ops_ms)
    distinct = np.mean([int(idx.unique().numel()) for idx in idx_sets])
    log(f"K1 at the unsupervised hop, idx [{UNSUP_HOP_ROWS},{FANOUTS[0]}] "
        f"into [{NUM_NODES + 1},{FEAT_DIM}] f32: kernel {ms:.4f} ms, K3 "
        f"{k3_ms:.4f} ms, plain {plain_ms:.4f} ms; {distinct:.0f} distinct "
        f"rows per launch; bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, "
        f"ops {ops_ms:.4f}); bound share K1 {bound_ms / ms:.3f}, K3 "
        f"{bound_ms / k3_ms:.3f}; max abs err K1 {err[False]:.3e}, K3 "
        f"{err[True]:.3e}, K2 at rate {DROPOUT} {err['K2']:.3e} (limit "
        f"{F32_TOL}), K2's mask identical ({flat.numel() * FEAT_DIM} "
        f"elements); on {card_line}")
    return {"ms": ms, "bound_ms": bound_ms}


def check_gather_rows(dev, card_line: str, data) -> dict:
    """K4 bit-equal to index_select (f32 and bf16 tables) at the hop and
    at ragged shapes; its time, index_select's (the plain version and
    the one library call at once) and its bound."""
    import torch

    from graphsage_tpu_torch.ops.gather import (
        fused_gather_rows,
        gather_rows_reference,
    )

    features = data[0]
    table_bf16 = features.to(torch.bfloat16)
    idx_sets = hop_idx_sets(dev, data, 8, seed=22)
    checked = []

    def compare(name, tab, idx):
        out = fused_gather_rows(tab, idx)
        ref = gather_rows_reference(tab, idx)
        check(out.dtype == tab.dtype and torch.equal(out, ref),
              f"K4 {name}: not equal to index_select")
        checked.append(name)

    for idx in idx_sets[:2]:
        compare("hop f32", features, idx)
        compare("hop bf16", table_bf16, idx)
    gen = torch.Generator(device=dev).manual_seed(23)
    for B, S, F in ((1, 1, 1), (7, 25, 602), (9, 10, 17), (33, 1, 640),
                    (7, 3, 8)):
        tab = torch.randn(65, F, generator=gen, device=dev)
        idx = torch.randint(0, 65, (B, S), generator=gen, device=dev,
                            dtype=torch.int32)
        compare(f"[{B},{S}] F={F}", tab, idx)
        compare(f"[{B},{S}] F={F} bf16", tab.to(torch.bfloat16), idx)
    # a table 8 bytes off a 16-byte boundary: narrower copies
    base = torch.randn(65 * 640 + 2, generator=gen, device=dev)
    compare("unaligned", base[2:].view(65, 640),
            torch.randint(0, 65, (6, 4), generator=gen, device=dev,
                          dtype=torch.int32))
    torch.cuda.synchronize()
    log(f"K4 vs index_select: bit-equal in all {len(checked)} cases "
        f"({', '.join(checked)})")

    ms = cuda_ms(cycling(lambda idx: fused_gather_rows(features, idx),
                         idx_sets))
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_rows_reference(features, idx), idx_sets))
    bf16_ms = cuda_ms(cycling(lambda idx: fused_gather_rows(table_bf16, idx),
                              idx_sets))
    bf16_plain_ms = cuda_ms(cycling(
        lambda idx: gather_rows_reference(table_bf16, idx), idx_sets))
    rows = HOP_ROWS * FANOUTS[0]

    def bound(elem_bytes):
        return float(np.mean([
            (int(torch.unique(idx).numel()) * FEAT_DIM * elem_bytes
             + rows * FEAT_DIM * elem_bytes + idx.numel() * 4)
            / HBM_BYTES_PER_S * 1e3 for idx in idx_sets]))

    bound_ms, bf16_bound_ms = bound(4), bound(2)
    log(f"K4 at idx [{HOP_ROWS},{FANOUTS[0]}] from the sampler into "
        f"[{NUM_NODES + 1},{FEAT_DIM}] f32: kernel {ms:.4f} ms, "
        f"index_select {plain_ms:.4f} ms (the plain version and the "
        f"library call), kernel / index_select {ms / plain_ms:.3f}; bound "
        f"{bound_ms:.4f} ms (bytes: {rows} rows written), bound share "
        f"{bound_ms / ms:.3f}; bf16 table: kernel {bf16_ms:.4f} ms, "
        f"index_select {bf16_plain_ms:.4f} ms, bound {bf16_bound_ms:.4f} "
        f"ms, share {bf16_bound_ms / bf16_ms:.3f}; on {card_line}")
    return {
        "name": "gather_rows",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_rows.cu",
        "replaces": "graphsage_tpu/ops/gather.py:483",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": plain_ms,
    }


def pool_operands(dev, seed: int, n: int, F: int, H: int):
    """A table [n+1, F] (the last row the zero dummy; rows 3 and 7 equal,
    so that the max sees ties; row 11 all negative) and a glorot w [F, H]
    and bias [H], made on the card from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(n + 1, F, generator=gen, device=dev)
    table[n] = 0
    if n > 11:
        table[7] = table[3]
        table[11] = -table[11].abs() - 1.0
    limit = float(np.sqrt(6.0 / (F + H)))
    w = (torch.rand(F, H, generator=gen, device=dev) * 2 - 1) * limit
    b = torch.randn(H, generator=gen, device=dev) * 0.1
    return table, w, b


def pool_idx(dev, rng, B: int, S: int, n: int):
    """[B, S] int32 ids into a pool_operands table, with max ties: row 0
    samples node 3 S times, row 1 starts with nodes 3 and 7."""
    import torch

    idx = rng.integers(0, n + 1, (B, S), dtype=np.int32)
    if n > 7:
        idx[0, :] = 3
        if B > 1 and S > 1:
            idx[1, :2] = [3, 7]
    return torch.from_numpy(idx).to(dev)


def pool_products(elem_bytes: int, dropout: bool) -> int:
    """TF32 products K5/K6 issue per product element: 3 (hi*hi + hi*lo +
    lo*hi), or 2 for a bf16 table without dropout (its rows are exact in
    TF32, lo = 0)."""
    return 3 if elem_bytes == 4 or dropout else 2


def pool_bounds(idx_sets, elem_bytes: int, residual: bool):
    """(bound ms, bytes ms, operations ms, f32 CUDA-core ms) of one K5/K6
    launch at the hop shape, averaged over ``idx_sets``: each distinct
    gathered row read once, w, b, idx read once, the output (and K6's
    residual) written once. Operations: the f32-accurate product as
    3xTF32 (2 for a bf16 table without dropout) of 2*F*H per gathered row
    at the tensor cores' TF32 rate; bias, relu and the reduce on the
    CUDA cores, and for K6 the mask's int32 work, which overlap it. The
    last value is the yardstick of the SIMT kernel K5/K6 replaced:
    the product in f32 on the CUDA cores."""
    import torch

    B, S, F, H = HOP_ROWS, FANOUTS[0], FEAT_DIM, POOL_HIDDEN
    bytes_ms = float(np.mean([
        (int(torch.unique(idx).numel()) * F * elem_bytes + F * H * 4 + H * 4
         + B * S * 4 + B * H * 4 + (B * S * F * 4 if residual else 0))
        / HBM_BYTES_PER_S * 1e3 for idx in idx_sets]))
    mma_ms = (pool_products(elem_bytes, residual) * 2 * B * S * F * H
              / TF32_OPS_PER_S * 1e3)
    epilogue_ms = 3 * B * S * H / F32_OPS_PER_S * 1e3
    int_ms = (B * S * F * K2_INT_OPS_PER_ELEM / INT32_OPS_PER_S * 1e3
              if residual else 0.0)
    ops_ms = max(mma_ms, epilogue_ms, int_ms)
    f32_ms = (2 * B * S * F * H + 3 * B * S * H) / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms, f32_ms


def check_pool(dev, card_line: str) -> dict:
    """K5 against its plain version (mean and max, f32 and bf16 tables,
    ragged shapes, ties); its times, the library route's and its bound
    at the hop (idx [5120, 25], F 602, H 512)."""
    import torch

    from graphsage_tpu_torch.ops.pool import (
        fused_gather_mlp_pool,
        gather_mlp_pool_reference,
    )

    rng = np.random.default_rng(10)
    table, w, b = pool_operands(dev, 10, NUM_NODES, FEAT_DIM, POOL_HIDDEN)
    table_bf16 = table.to(torch.bfloat16)
    idx_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                .to(dev) for _ in range(8)]
    err = {}

    def compare(name, tab, idx, w_, b_, reduce):
        out = fused_gather_mlp_pool(tab, idx, w_, b_, reduce)
        ref = gather_mlp_pool_reference(tab, idx, w_, b_, reduce)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"K5 {name}: bad output")
        err[name] = max(err.get(name, 0.0), float((out - ref).abs().max()))

    for reduce in ("mean", "max"):
        for dt, tab in (("f32", table), ("bf16", table_bf16)):
            compare(f"hop {dt} {reduce}", tab, idx_sets[0], w, b, reduce)
    # ragged: S=1, F odd, H not a multiple of the 128-column tile, B not a
    # multiple of the block's rows, S above the block's 128 rows
    for B, S, F, H in ((1, 1, 1, 1), (7, 25, 602, 512), (33, 1, 17, 24),
                       (9, 10, 17, 24), (3, 200, 33, 130),
                       (300, 25, 602, 512)):
        tab, w_, b_ = pool_operands(dev, B + S + F + H, 64, F, H)
        idx = pool_idx(dev, rng, B, S, 64)
        for reduce in ("mean", "max"):
            compare(f"ragged {reduce}", tab, idx, w_, b_, reduce)
            compare(f"ragged bf16 {reduce}", tab.to(torch.bfloat16), idx,
                    w_, b_, reduce)
    # the dummy row alone pools to relu(b)
    tab, w_, b_ = pool_operands(dev, 3, 64, 17, 24)
    dummy = torch.full((2, 3), 64, dtype=torch.int32, device=dev)
    got = fused_gather_mlp_pool(tab, dummy, w_, b_, "max")
    check(bool(torch.equal(got, torch.relu(b_).expand(2, 24))),
          "K5: the dummy row did not pool to relu(b)")
    torch.cuda.synchronize()
    worst = max(err.values())
    log("K5 vs plain, max abs err: " + ", ".join(
        f"{k} {v:.3e}" for k, v in err.items()) + f" (limit {POOL_TOL})")
    check(worst <= POOL_TOL, f"K5 error {worst} > {POOL_TOL}")

    B, S, H = HOP_ROWS, FANOUTS[0], POOL_HIDDEN

    def library(idx):
        rows = table.index_select(0, idx.view(-1))
        return torch.relu(torch.addmm(b, rows, w)).view(B, S, H).mean(dim=1)

    ms = cuda_ms(cycling(
        lambda idx: fused_gather_mlp_pool(table, idx, w, b, "mean"),
        idx_sets), iters=20)
    max_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mlp_pool(table, idx, w, b, "max"),
        idx_sets), iters=20)
    bf16_ms = cuda_ms(cycling(
        lambda idx: fused_gather_mlp_pool(table_bf16, idx, w, b, "mean"),
        idx_sets), iters=20)
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mlp_pool_reference(table, idx, w, b, "mean"),
        idx_sets), iters=20)
    library_ms = cuda_ms(cycling(library, idx_sets), iters=20)
    # informational: one cuBLAS product in a single TF32 pass, which the
    # kernel may not take (it misses POOL_TOL); never library_ms
    rows = table.index_select(0, idx_sets[0].view(-1))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_ms = cuda_ms(lambda: torch.addmm(b, rows, w), iters=20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del rows
    bound_ms, bytes_ms, ops_ms, f32_ms = pool_bounds(idx_sets, 4,
                                                     residual=False)
    bf16_bound, _, bf16_ops, _ = pool_bounds(idx_sets, 2, residual=False)
    flop = 2 * B * S * FEAT_DIM * H
    log(f"K5 at idx [{B},{S}] into [{NUM_NODES + 1},{FEAT_DIM}] f32, w "
        f"[{FEAT_DIM},{H}], mean: kernel {ms:.4f} ms (max {max_ms:.4f}, "
        f"bf16 table {bf16_ms:.4f}), plain {plain_ms:.4f} ms, library route "
        f"{library_ms:.4f} ms (four calls: index_select, addmm (cuBLAS f32, "
        f"TF32 off), relu, mean; no single PyTorch call computes this); "
        f"bound {bound_ms:.4f} ms (operations {ops_ms:.4f}: 3xTF32 at "
        f"{TF32_OPS_PER_S:.3g}/s; bytes {bytes_ms:.4f}; the f32 "
        f"CUDA-core bound {f32_ms:.4f}); bound share {bound_ms / ms:.3f} "
        f"(of the f32 CUDA-core bound {f32_ms / ms:.3f}); "
        f"{flop / ms / 1e9:.2f} TFLOP/s of f32 product, "
        f"{3 * flop / ms / 1e9:.2f} of TF32; bf16 table: bound "
        f"{bf16_bound:.4f} ms (operations {bf16_ops:.4f}, 2xTF32), share "
        f"{bf16_bound / bf16_ms:.3f}, {2 * flop / bf16_ms / 1e9:.2f} TFLOP/s "
        f"of TF32; informational floor: one cuBLAS addmm [{B * S},"
        f"{FEAT_DIM}] x [{FEAT_DIM},{H}] with TF32 on {tf32_ms:.4f} ms "
        f"(1xTF32, not the same accuracy; TF32 off again); on {card_line}")
    return {
        "name": "gather_mlp_pool",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mlp_pool.cu",
        "replaces": "graphsage_tpu/ops/pool.py:79",
        "launches": None,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def check_pool_train(dev, card_line: str) -> dict:
    """K6 against its plain version: the residual bit-equal to the plain
    dropped rows, the mask identical to dropout_keep_mask, the rate's
    zero fraction and the 1/keep scale, the pooled output, and the
    gradients of gather_mlp_pool_train against autograd of the plain
    composition (mean and max, ties included); times and bounds."""
    import torch

    from graphsage_tpu_torch.models.graphsage import KERNEL_DROP_TAG
    from graphsage_tpu_torch.ops.philox import dropout_keep_mask
    from graphsage_tpu_torch.ops.pool import (
        fused_gather_mlp_pool,
        gather_mlp_pool_reference,
        gather_mlp_pool_train,
        gather_mlp_pool_with_rows,
        gathered_rows_reference,
        pool_rows,
    )

    rng = np.random.default_rng(11)
    table, w, b = pool_operands(dev, 11, NUM_NODES, FEAT_DIM, POOL_HIDDEN)
    idx_sets = [torch.from_numpy(zipf_ids(rng, (HOP_ROWS, FANOUTS[0])))
                .to(dev) for _ in range(8)]
    B, S, F, H = HOP_ROWS, FANOUTS[0], FEAT_DIM, POOL_HIDDEN
    seed, offset = 0x0123456789ABCDEF, (17, KERNEL_DROP_TAG)
    key = dict(seed=seed, offset=offset)
    keep = dropout_keep_mask(B * S, F, DROPOUT, seed, *offset, device=dev)
    err = 0.0
    for name, tab in (("f32", table), ("bf16", table.to(torch.bfloat16))):
        for reduce in ("mean", "max"):
            out, x = gather_mlp_pool_with_rows(tab, idx_sets[0], w, b,
                                               reduce, DROPOUT, **key)
            x_ref = gathered_rows_reference(tab, idx_sets[0], DROPOUT, **key)
            check(bool(torch.equal(x, x_ref)),
                  f"K6 {name}: the residual differs from the plain dropped "
                  f"rows in {int((x != x_ref).sum())} elements")
            # nonzero exactly where kept (randn holds a few exact zeros)
            nonzero = gathered_rows_reference(tab, idx_sets[0]) != 0
            check(bool(torch.equal(x != 0, keep & nonzero)),
                  f"K6 {name}: mask differs from dropout_keep_mask")
            del nonzero
            ref = pool_rows(x_ref, w, b, reduce, S)
            err = max(err, float((out - ref).abs().max()))
            del out, x, x_ref, ref
    # K5 with dropout (no residual) draws the same mask
    k5 = fused_gather_mlp_pool(table, idx_sets[1], w, b, "mean", DROPOUT,
                               **key)
    k5_ref = gather_mlp_pool_reference(table, idx_sets[1], w, b, "mean",
                                       DROPOUT, **key)
    err = max(err, float((k5 - k5_ref).abs().max()))
    log(f"K6 vs plain at idx [{B},{S}], rate {DROPOUT}: residual "
        f"[{B * S},{F}] bit-equal and mask identical ({B * S * F} elements, "
        f"f32 and bf16 tables, mean and max); pooled max abs err "
        f"{err:.3e} (limit {POOL_TOL}, K5 with dropout included)")
    check(err <= POOL_TOL, f"K6 error {err} > {POOL_TOL}")

    ones = torch.ones(64, 37, device=dev)
    eye = torch.eye(37, 8, device=dev)
    s1 = torch.from_numpy(rng.integers(0, 64, (HOP_ROWS, 1),
                                       dtype=np.int32)).to(dev)
    _, x = gather_mlp_pool_with_rows(ones, s1, eye, torch.zeros(8, device=dev),
                                     "mean", DROPOUT, **key)
    zero_frac = float((x == 0).float().mean())
    scale_ok = bool((x[x != 0] == float(np.float32(1 / (1 - DROPOUT)))).all())
    log(f"K6 at rate {DROPOUT}, all-ones table, {x.numel()} elements: zero "
        f"fraction {zero_frac:.5f} (limit +-0.005), kept values all 1/keep: "
        f"{scale_ok}")
    check(abs(zero_frac - DROPOUT) <= 0.005, f"K6 zero fraction {zero_frac}")
    check(scale_ok, "K6 kept values are not 1/keep")

    # gradients: the Function (K6 forward, route_pool_grad backward)
    # against autograd of the plain composition, ties included
    g_err = 0.0
    for reduce in ("mean", "max"):
        for rate in (0.0, DROPOUT):
            tab, w0, b0 = pool_operands(dev, 12, 64, FEAT_DIM, POOL_HIDDEN)
            idx = pool_idx(dev, rng, 96, S, 64)
            cot = torch.randn(96, POOL_HIDDEN, device=dev)
            kw = key if rate > 0 else {}
            w1, b1 = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            before = launch_counts()["K6"]
            (gather_mlp_pool_train(tab, idx, w1, b1, reduce, rate, **kw)
             * cot).sum().backward()
            check(launch_counts()["K6"] == before + 1,
                  "gather_mlp_pool_train did not launch K6 under autograd")
            w2, b2 = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            (pool_rows(gathered_rows_reference(tab, idx, rate, **kw), w2, b2,
                       reduce, S) * cot).sum().backward()
            for got, want in ((w1.grad, w2.grad), (b1.grad, b2.grad)):
                torch.testing.assert_close(got, want, **GRAD_TOL)
                g_err = max(g_err, float((got - want).abs().max()))
    log(f"K6 Function grads (w, b) vs autograd of the plain composition, "
        f"mean and max, rate 0 and {DROPOUT}, max-tie rows included: max "
        f"abs diff {g_err:.3e} (rtol {GRAD_TOL['rtol']}, atol "
        f"{GRAD_TOL['atol']})")

    ms = cuda_ms(cycling(
        lambda idx: gather_mlp_pool_with_rows(table, idx, w, b, "mean",
                                              DROPOUT, **key), idx_sets),
        iters=20)
    plain_ms = cuda_ms(cycling(
        lambda idx: gather_mlp_pool_reference(table, idx, w, b, "mean",
                                              DROPOUT, **key), idx_sets),
        iters=5, warmup=1)
    bound_ms, bytes_ms, ops_ms, f32_ms = pool_bounds(idx_sets, 4,
                                                     residual=True)
    log(f"K6 at idx [{B},{S}] into [{NUM_NODES + 1},{F}] f32, w [{F},{H}], "
        f"mean, rate {DROPOUT}, residual [{B * S},{F}] f32: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms (operations "
        f"{ops_ms:.4f}: 3xTF32 at {TF32_OPS_PER_S:.3g}/s; bytes "
        f"{bytes_ms:.4f} with the residual; the f32 CUDA-core bound "
        f"{f32_ms:.4f}); bound share {bound_ms / ms:.3f} (of the f32 "
        f"CUDA-core bound {f32_ms / ms:.3f}); "
        f"{2 * B * S * F * H / ms / 1e9:.2f} TFLOP/s of f32 product, "
        f"{6 * B * S * F * H / ms / 1e9:.2f} of TF32; library: none (no "
        f"PyTorch call draws a per-element mask inside a gather-MLP-pool); "
        f"on {card_line}")
    return {
        "name": "gather_mlp_pool_train",
        "route": "cuda",
        "source": "graphsage_tpu_torch/ops/csrc/gather_mlp_pool.cu",
        "replaces": "graphsage_tpu/ops/pool.py:308",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


# ------------------------------------------------------------ K7, the probe

# the probe's own entry point, as a user runs it: the fewest variants
# that launch every K7 instance and K1 (check_probe times them), each
# gather run INNER x (1 + 3 ITERS) times
PROBE_VARIANTS = "k1,plain,bulkwait,tilewait,hot1024,hotmx1024,hc1024"
PROBE_INNER, PROBE_ITERS = 2, 1


def check_probe(dev, card_line: str) -> list:
    """Every K7 instance against its plain version at the probe's shape
    (N = 100k, F = 640, B = 1024, S = 25), zipf and uniform ids, K 1024
    and 4096, f32 tables and bf16 for the wait kinds; then each one's
    time beside K1, index_select + mean and embedding_bag on the zipf
    ids. Returns the K7 entries of the kernels line (launches filled in
    by the entry point's run)."""
    import torch
    import torch.nn.functional as fnn

    from graphsage_tpu_torch.benchmarks import gather_probe as gp
    from graphsage_tpu_torch.ops import gather_probe as ops
    from graphsage_tpu_torch.ops.gather import (
        fused_gather_mean,
        gather_mean_reference,
    )

    N, S = gp.N, gp.S
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(N + 1, gp.F, generator=gen, device=dev)
    table[N] = 0
    t16 = table.to(torch.bfloat16)
    rng = np.random.default_rng(0)
    ids = {d: torch.from_numpy(gp.make_ids(d, rng, 4)).to(dev)
           for d in ("zipf", "uniform")}

    err = {}

    def hold(key, out, ref):
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"{key}: output not finite or of shape {tuple(out.shape)}")
        err[key] = max(err.get(key, 0.0), float((out - ref).abs().max()))

    for sets in ids.values():
        for idx in sets[:2]:
            for wait in ops.WAITS:
                for tab in (table, t16):
                    hold(f"K7a.{wait}", ops.probe_gather(tab, idx, wait),
                         gather_mean_reference(tab, idx))
            for K in (1024, 4096):
                hold("K7a.hot", ops.probe_gather_hot(table, idx, K),
                     gather_mean_reference(table, idx))
                idx_dma, nb, _ = ops.cold_first_topk(idx, K, N)
                cold = ops.probe_coldsw(table, idx_dma, nb, S)
                cold_ref = ops.coldsw_reference(table, idx_dma, nb, S)
                hold("K7a.compacted", cold, cold_ref)
                hot = ops.probe_hotcount(idx, t16[:K])
                hot_ref = ops.hotcount_reference(idx, t16[:K])
                hold("K7b", hot, hot_ref)
                hold("hc", cold + hot, cold_ref + hot_ref)
                stable = ops.cold_first_stable(idx, K, N)
                hold("K7c", ops.probe_hotmx(table, idx, *stable, K),
                     ops.hotmx_reference(table, idx, *stable, K))
    torch.cuda.synchronize()
    log("K7 vs plain, max abs err over zipf and uniform ids, K 1024 and "
        "4096 (f32 and bf16 tables for the waits): "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f" (limit {PROBE_TOL})")
    for key, e in err.items():
        check(e <= PROBE_TOL, f"{key} error {e} > {PROBE_TOL}")

    sets = list(ids["zipf"])

    def timed(fn, args=sets):
        return cuda_ms(cycling(fn, args))

    library = timed(lambda idx: fnn.embedding_bag(idx, table, mode="mean"))
    plain = timed(lambda idx: gather_mean_reference(table, idx))
    log(f"probe at idx [{gp.B},{S}] into [{N + 1},{gp.F}] f32, zipf: K1 "
        f"{timed(lambda idx: fused_gather_mean(table, idx)):.4f} ms, "
        f"index_select + mean "
        f"{timed(lambda idx: gp.xla_gather_mean(table, idx)):.4f} ms, "
        f"embedding_bag {library:.4f} ms, plain {plain:.4f} ms; on "
        f"{card_line}")

    entries = {}

    def record(key, ms, plain_ms, library_ms, kind, K, note=""):
        bound, by = gp.bound_ms(kind, ids["zipf"], 4, K)
        log(f"{key} ({kind}, K {K}): {ms:.4f} ms{note}, plain "
            f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}), share {bound / ms:.3f}")
        if key not in entries:     # the line keeps K = 1024
            name, replaces = next((n, r) for k, n, r in K7_INSTANCES
                                  if k == key)
            entries[key] = {
                "name": name, "route": "cuda",
                "source": "graphsage_tpu_torch/ops/csrc/gather_probe.cu",
                "replaces": replaces, "launches": None,
                "max_abs_err": err[key], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": library_ms}

    for wait in ops.WAITS:
        ms = timed(lambda idx, w=wait: ops.probe_gather(table, idx, w))
        bf16 = timed(lambda idx, w=wait: ops.probe_gather(t16, idx, w))
        record(f"K7a.{wait}", ms, plain, library, "plain", 0,
               f" (bf16 table {bf16:.4f} ms)")
    uniform = list(ids["uniform"])
    k1_ms = timed(lambda idx: fused_gather_mean(table, idx), uniform)
    waits_ms = [timed(lambda idx, w=w: ops.probe_gather(table, idx, w),
                      uniform) for w in ops.WAITS]
    bound, _ = gp.bound_ms("plain", ids["uniform"], 4, 0)
    log(f"uniform ids: bound {bound:.4f} ms (bytes), K1 {k1_ms:.4f} ms, "
        "K7a per sample, row, tile "
        + ", ".join(f"{ms:.4f}" for ms in waits_ms) + " ms")
    for K in (1024, 4096):
        record("K7a.hot", timed(
            lambda idx, k=K: ops.probe_gather_hot(table, idx, k)), plain,
            library, "hot", K)
        # the compactions run in torch before the kernels, as the JAX
        # probe runs them in XLA: timed on their own lines
        log(f"id compactions, K {K}: top_k (coldsw, hc) "
            f"{timed(lambda idx, k=K: ops.cold_first_topk(idx, k, N)):.4f}"
            f" ms, stable (hotmx) "
            f"{timed(lambda idx, k=K: ops.cold_first_stable(idx, k, N)):.4f}"
            " ms a call, in no kernel's time below")
        preps = [ops.cold_first_topk(idx, K, N) for idx in sets]
        bags = [(p[0], p[2] / S) for p in preps]
        record("K7a.compacted",
               timed(lambda p: ops.probe_coldsw(table, p[0], p[1], S), preps),
               timed(lambda p: ops.coldsw_reference(table, p[0], p[1], S),
                     preps),
               timed(lambda b: fnn.embedding_bag(
                   b[0], table, per_sample_weights=b[1], mode="sum"), bags),
               "coldsw", K)
        hot = t16[:K]
        hot_bags = [(torch.where(idx < K, idx, 0),
                     (idx < K).to(torch.float32) / S) for idx in sets]
        record("K7b", timed(lambda idx: ops.probe_hotcount(idx, hot)),
               timed(lambda idx: ops.hotcount_reference(idx, hot)),
               timed(lambda b, k=K: fnn.embedding_bag(
                   b[0], table[:k], per_sample_weights=b[1], mode="sum"),
                   hot_bags), "hotcount", K)
        stables = [(idx, *ops.cold_first_stable(idx, K, N)) for idx in sets]
        record("K7c", timed(lambda p, k=K: ops.probe_hotmx(table, *p, k),
                            stables),
               timed(lambda p, k=K: ops.hotmx_reference(table, *p, k),
                     stables), library, "hotmx", K)
    return [entries[key] for key, _, _ in K7_INSTANCES]


def drive_probe(dev, card_line: str) -> dict:
    """The probe's entry point as a user runs it
    (``python -m graphsage_tpu_torch.benchmarks.gather_probe``) on zipf
    ids, with short trials (its times are check_probe's to measure): it
    must exit 0, check each variant against index_select + mean, and
    launch every K7 instance (and K1, its yardstick) and nothing else."""
    from graphsage_tpu_torch.benchmarks import gather_probe as gp

    inner, iters = gp.INNER, gp.ITERS
    gp.INNER, gp.ITERS = PROBE_INNER, PROBE_ITERS
    reset_counts()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = gp.main(["--dist", "zipf", "--variants", PROBE_VARIANTS])
    finally:
        gp.INNER, gp.ITERS = inner, iters
    counts = launch_counts()
    for line in out.getvalue().splitlines():
        log(f"probe: {line}")
    check(rc == 0, f"the probe's entry point exited {rc}")
    log(f"probe entry point (zipf) launches: {counts}; on {card_line}")
    for key in KERNELS:
        if key.startswith("K7") or key == "K1":
            check(counts[key] > 0, f"probe: {key} never launched")
        else:
            check(counts[key] == 0, f"probe: {key} launched {counts[key]}")
    return counts


def sass_ops(lib: str) -> dict:
    """{function name: {opcode: count}} of a built library's SASS, from
    cuobjdump where the toolkit has it (else empty)."""
    from graphsage_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: no SASS summary")
        return {}
    out = subprocess.run([tool, "-sass", str(build.BUILD_DIR / lib)],
                         capture_output=True, text=True, timeout=120,
                         check=False).stdout
    functions = {}
    for block in out.split("Function : ")[1:]:
        counts = {}
        for line in block.splitlines():
            text = line.split("*/", 1)[1] if "*/" in line else ""
            words = text.replace(";", " ").split()
            if line.strip().startswith("/*") and words:
                op = words[1] if words[0].startswith("@") else words[0]
                counts[op] = counts.get(op, 0) + 1
        functions[block.split("\n")[0].strip()] = counts
    return functions


def sass_summary() -> None:
    """Static instruction counts from cuobjdump: K2 (f32, 2 elements per
    load), the record behind K2_INT_OPS_PER_ELEM; and each K5/K6
    instance's tensor-core (HGMMA, HMMA) and f32 FMA instructions. The
    instances the hop runs (f32 table, mean: K5 without dropout, K6 with
    dropout and the residual) must issue HGMMA. Each K7 instance's bulk
    copies (UBLKCP) and HMMA: K7a and K7c must issue bulk copies, K7b and
    K7c HMMA."""
    for name, counts in sass_ops("libgather_mean.so").items():
        if "gather_mean_dropout_kernelIfLi2E" in name:
            top = sorted(counts.items(), key=lambda kv: -kv[1])[:8]
            log(f"SASS of K2<float,2>: {sum(counts.values())} instructions; "
                + ", ".join(f"{k} {v}" for k, v in top))
    hop = {"IfLb0ELb0ELb0E": "K5 hop", "IfLb0ELb1ELb1E": "K6 hop"}
    seen = set()
    for name, counts in sass_ops("libgather_mlp_pool.so").items():
        if "gather_mlp_pool_kernel" not in name:
            continue
        args = name.split("gather_mlp_pool_kernel", 1)[1]
        flags = args.split("Lb")[1:4]
        label = ("bf16" if "bfloat16" in args else "f32") + "".join(
            f" {k}{f[0]}" for k, f in zip(("max", "drop", "x"), flags))
        mma = {op: n for op, n in counts.items()
               if op.split(".")[0] in ("HGMMA", "HMMA")}
        ffma = sum(n for op, n in counts.items()
                   if op.split(".")[0] == "FFMA")
        tag = next((v for k, v in hop.items() if args.startswith(k)), "")
        mma_ops = ", ".join(f"{k} {v}" for k, v in sorted(mma.items()))
        log(f"SASS of gather_mlp_pool_kernel<{label}>"
            f"{f' ({tag})' if tag else ''}: {sum(counts.values())} "
            f"instructions; tensor-core {sum(mma.values())} ({mma_ops}); "
            f"FFMA {ffma}")
        if tag:
            check(sum(mma.values()) > 0, f"{tag} instance issues no HGMMA")
            seen.add(tag)
    if seen:
        check(seen == set(hop.values()), f"hop instances missing: {seen}")
    # K7: every instance's bulk copies (UBLKCP) and tensor-core (HMMA)
    # instructions; K7a and K7c must issue bulk copies, K7b and K7c HMMA
    for name, counts in sass_ops("libgather_probe.so").items():
        kernel = next((k for k in ("probe_gather_kernel",
                                   "probe_hotcount_kernel",
                                   "probe_hotmx_kernel") if k in name), None)
        if kernel is None:
            continue
        label = kernel + name.split(kernel, 1)[1].split("EEv")[0]
        bulk = sum(n for op, n in counts.items() if op.startswith("UBLKCP"))
        mma = {op: n for op, n in counts.items()
               if op.split(".")[0] == "HMMA"}
        log(f"SASS of {label}: {sum(counts.values())} instructions; bulk "
            f"copies {bulk}; tensor-core {sum(mma.values())} "
            f"({', '.join(f'{k} {v}' for k, v in sorted(mma.items()))})")
        if kernel != "probe_hotcount_kernel":
            check(bulk > 0, f"{label} issues no bulk copy (UBLKCP)")
        if kernel != "probe_gather_kernel":
            check(sum(mma.values()) > 0, f"{label} issues no HMMA")


# ------------------------------------------------------------ phase 4

def bench_data(dev):
    """bench.py's graph at full width, made on the host from seed 0 and
    moved once: (features [N+1, F] f32 with the zero dummy row, zipf
    adjacency [N+1, 128] int32, one-hot labels [N, C] on the host)."""
    import torch

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((NUM_NODES, FEAT_DIM)).astype(np.float32)
    adj_np = zipf_ids(rng, (NUM_NODES + 1, MAX_DEGREE))
    adj_np[NUM_NODES] = NUM_NODES   # the dummy node points at itself
    labels_np = np.eye(NUM_CLASSES, dtype=np.float32)[
        rng.integers(0, NUM_CLASSES, NUM_NODES)]
    features = torch.from_numpy(feats).to(dev)
    features = torch.cat([features, features.new_zeros(1, FEAT_DIM)])
    return features, torch.from_numpy(adj_np).to(dev), labels_np


def bench_config(fused: bool, dropout: float = 0.0,
                 aggregator: str = "mean", dedup: bool = False,
                 rows: bool = False):
    """bench.py's model (meanpool and maxpool: MLP hidden width 512, seq:
    LSTM hidden width 128, "small")."""
    from graphsage_tpu_torch.models.graphsage import LayerInfo, SAGEConfig
    from graphsage_tpu_torch.models.supervised import SupervisedConfig

    sage = SAGEConfig(
        layers=(LayerInfo(FANOUTS[0], DIMS[0]),
                LayerInfo(FANOUTS[1], DIMS[1])),
        feature_dim=FEAT_DIM, aggregator=aggregator, concat=True,
        model_size="small", num_nodes=NUM_NODES, sampler_mode="shared_perm",
        fused_gather=fused, dropout=dropout, dedup_gather=dedup,
        rows_gather=rows)
    return SupervisedConfig(sage=sage, num_classes=NUM_CLASSES)


def serve_full_width(dev, data, label: str, config, kernel: str,
                     ref_config=None, ref_preds=None, repeats: int = 2,
                     n_requests: int | None = None):
    """The eval sweep over all 100k nodes with ``config`` (weights from
    seed 0); returns the launch count of ``kernel`` in it, which must be
    one per batch with no other kernel, and the predictions. These are
    held to 1e-5 of ``ref_preds`` (another sweep over the same samples
    with the same weights) or else of ``ref_config``'s path over the
    first 4 batches. Then ``repeats`` more sweeps, ``n_requests``
    requests one at a time (every batch by default) and a profile of 20
    batches."""
    import torch

    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.train.metrics import calc_f1
    from graphsage_tpu_torch.train.supervised import (
        _run_eval_sweep as run_eval_sweep,
    )
    from graphsage_tpu_torch.train.supervised import make_eval_sweep

    features, adj, labels_np = data
    params = init_supervised_params(torch.Generator().manual_seed(0),
                                    config, device=dev)
    sweep = make_eval_sweep(config, BATCH, NUM_NODES)
    nodes = np.arange(NUM_NODES)
    n_b = -(-NUM_NODES // BATCH)

    def generator():
        return torch.Generator(device=dev).manual_seed(1)

    run_eval_sweep(sweep, params, features, adj, nodes[:2 * BATCH],
                   labels_np, BATCH, NUM_NODES, generator())   # warm-up

    reset_counts()
    loss, preds, labels, dt = run_eval_sweep(
        sweep, params, features, adj, nodes, labels_np, BATCH, NUM_NODES,
        generator())
    counts = launch_counts()
    launches = counts[kernel]

    log(f"{label}: served {NUM_NODES} nodes in {n_b} batches of "
        f"{BATCH}: {dt * 1e3:.2f} ms, {NUM_NODES / dt:.1f} nodes/s; kernel "
        f"launches {counts}")
    check_counts(counts, kernel, n_b, f"{label} serving sweep")
    check(preds.shape == (NUM_NODES, NUM_CLASSES),
          f"preds shape {preds.shape}")
    check(bool(np.isfinite(preds).all()) and np.isfinite(loss),
          "non-finite predictions or loss")
    row_sums = preds.sum(axis=1)
    check(bool(np.abs(row_sums - 1.0).max() < 1e-4),
          "softmax rows do not sum to 1")
    f1_mic, f1_mac = calc_f1(labels, preds, False)
    log(f"loss {loss:.5f}, f1_micro {f1_mic:.5f}, f1_macro {f1_mac:.5f} "
        f"(random weights and labels: chance is ~{1 / NUM_CLASSES:.4f})")

    # the same samples (same sampler stream) through the reference path
    # give the same predictions
    if ref_preds is not None:
        diff = float(np.abs(ref_preds - preds).max())
        log(f"{label} vs the reference sweep, all {NUM_NODES} nodes: max "
            f"abs diff {diff:.3e} (limit 1e-5)")
    else:
        n_ref = 4 * BATCH
        _, ref4, _, _ = run_eval_sweep(
            make_eval_sweep(ref_config, BATCH, NUM_NODES), params, features,
            adj, nodes[:n_ref], labels_np, BATCH, NUM_NODES, generator())
        diff = float(np.abs(ref4 - preds[:n_ref]).max())
        log(f"{label} with vs without {kernel}, first {n_ref} nodes: max "
            f"abs diff {diff:.3e} (limit 1e-5)")
    check(diff <= 1e-5, f"{label}: predictions differ by {diff}")

    for rep in range(repeats):
        _, _, _, dt_rep = run_eval_sweep(
            sweep, params, features, adj, nodes, labels_np, BATCH,
            NUM_NODES, generator())
        log(f"{label} sweep repeat {rep + 1}: {dt_rep * 1e3:.2f} ms, "
            f"{NUM_NODES / dt_rep:.1f} nodes/s")

    # requests one at a time: one batch of 512 ids in, predictions back
    # on the host
    ids_all = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids_all[:NUM_NODES] = nodes
    ids_dev = torch.from_numpy(ids_all).to(dev)
    labels_table = torch.zeros(NUM_NODES + 1, NUM_CLASSES, device=dev)
    labels_table[:NUM_NODES] = torch.from_numpy(labels_np).to(dev)
    gen = generator()
    lat = []
    for i in range(n_requests or n_b):
        t1 = time.perf_counter()
        _, p = sweep(params, features, adj,
                     ids_dev[i * BATCH:(i + 1) * BATCH], labels_table, gen)
        p.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"{label} per request of {BATCH} nodes ({len(lat)} requests): p50 "
        f"{np.percentile(lat, 50):.3f} ms, "
        f"p90 {np.percentile(lat, 90):.3f} ms, max {max(lat):.3f} ms")

    profile_window(
        lambda: sweep(params, features, adj, ids_dev[:20 * BATCH],
                      labels_table, gen),
        f"{label} sweep of 20 batches")
    return launches, preds


def serve_rows_batches(dev, data, aggregator: str, n_batches: int = 4):
    """``n_batches`` of the eval sweep with ``aggregator`` through K4
    (rows_gather) and through the plain gather, with the same weights and
    samples: K4 once per batch, the predictions within 1e-5."""
    import torch

    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.train.supervised import (
        _run_eval_sweep as run_eval_sweep,
    )
    from graphsage_tpu_torch.train.supervised import make_eval_sweep

    features, adj, labels_np = data
    nodes = np.arange(n_batches * BATCH)
    params = init_supervised_params(
        torch.Generator().manual_seed(0),
        bench_config(True, aggregator=aggregator), device=dev)
    out = {}
    for rows in (True, False):
        config = bench_config(True, aggregator=aggregator, rows=rows)
        reset_counts()
        _, preds, _, dt = run_eval_sweep(
            make_eval_sweep(config, BATCH, NUM_NODES), params, features, adj,
            nodes, labels_np, BATCH, NUM_NODES,
            torch.Generator(device=dev).manual_seed(1))
        out[rows] = (preds, launch_counts(), dt)
    diff = float(np.abs(out[True][0] - out[False][0]).max())
    log(f"{aggregator} with rows_gather, {n_batches} batches (first calls "
        f"included): {out[True][2] * 1e3:.2f} ms, launches {out[True][1]}; "
        f"plain gather {out[False][2] * 1e3:.2f} ms; predictions max abs "
        f"diff {diff:.3e} (limit 1e-5)")
    check_counts(out[True][1], "K4", n_batches, f"{aggregator} rows_gather")
    check_counts(out[False][1], "K4", 0, f"{aggregator} plain gather")
    check(bool(np.isfinite(out[True][0]).all()), "non-finite predictions")
    check(diff <= 1e-5, f"{aggregator}: K4 and plain predictions differ by "
          f"{diff}")


def profile_window(fn, label: str):
    """Device time by kernel over one call of ``fn``, and the device's
    busy share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if getattr(evt, "is_user_annotation", False):
            continue   # a range around kernels counted on their own
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            rows.append((dev_us, evt.count, evt.key))
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("profiler: no device time recorded (not measured)")
        return
    log(f"profiler, {label}: wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({busy_us / wall_us:.3f} of the window, profiler on), "
        f"{sum(r[1] for r in rows)} device kernels")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {dev_us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")


# ------------------------------------------------------------ phase 5

def train_full_width(dev, data, label: str, config, kernel: str,
                     chunks: int = 3, chunk_steps: int = TRAIN_CHUNK,
                     n_sync: int = 10, n_profile: int = 5) -> int:
    """bench.py's model in ``config``, Adam at lr 1e-2, through the chunk
    runner: ``chunks`` timed chunks of ``chunk_steps`` steps; returns the
    launch count of ``kernel``, which must be one per step with no other
    kernel, over the timed chunks."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    params = init_supervised_params(torch.Generator().manual_seed(0), config,
                                    device=dev)
    optimizer = make_optimizer(LEARNING_RATE)
    opt_state = optimizer.init(params)
    run = make_supervised_chunk_runner(config, optimizer, BATCH)
    n_b = -(-NUM_NODES // BATCH)
    host_rng = np.random.default_rng(4)
    ids_padded = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids_padded[:NUM_NODES] = np.arange(NUM_NODES)
    ids_perm = torch.from_numpy(
        ids_padded[host_rng.permutation(len(ids_padded))]).to(dev)
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    drop_seed = int(host_rng.integers(0, 2**63))
    step = 0

    def chunk(n):
        nonlocal params, opt_state, step
        params, opt_state, loss, logits, ids = run(
            params, opt_state, gen, features, adj, ids_perm, labels_table,
            step, n, drop_seed=drop_seed)
        step += n
        return loss, logits

    loss, _ = chunk(5)                       # warm-up
    check(np.isfinite(float(loss)), "non-finite loss in warm-up")

    reset_counts()
    times, losses = [], []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, logits = chunk(chunk_steps)
        losses.append(float(loss))           # the print boundary
        times.append(time.perf_counter() - t0)
        check(np.isfinite(losses[-1]), f"non-finite loss {losses[-1]}")
    counts = launch_counts()
    n_steps = chunks * chunk_steps
    check_counts(counts, kernel, n_steps, f"{label} training")
    check(logits.shape == (BATCH, NUM_CLASSES)
          and bool(torch.isfinite(logits).all()), "bad training logits")
    for i, (dt, lv) in enumerate(zip(times, losses)):
        log(f"{label} train chunk {i + 1}: {chunk_steps} steps in "
            f"{dt * 1e3:.2f} ms,"
            f" {dt / chunk_steps * 1e3:.4f} ms/step, "
            f"{EDGES_PER_STEP * chunk_steps / dt:.1f} edges/s, loss "
            f"{lv:.5f}")
    log(f"{label} training: launches {counts} in {n_steps} steps; "
        f"{EDGES_PER_STEP} edges per step; losses {losses}")
    count_syncs(label, lambda: chunk(n_sync), n_sync)
    profile_window(lambda: chunk(n_profile),
                   f"{label}, {n_profile} training steps")
    return counts[kernel]


def count_syncs(label: str, run, n_steps: int) -> float:
    """Host synchronisations in ``run()`` (``n_steps`` training steps),
    logged with the stack of each; returns them per step."""
    import traceback
    import warnings

    import torch

    stacks, notices = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        frames = traceback.extract_stack()[:-1]
        if any(f.name == "set_sync_debug_mode" for f in frames[-3:]):
            # raised by the call that switches the mode (line of
            # chip_smoke.py given), not by the chunk's work
            notices.append(f"{str(message).splitlines()[0][:100]!r} at the "
                           f"switch on line {frames[-3].lineno}")
        elif "synchroniz" in str(message):
            stacks.append(" <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in reversed(frames[-6:])))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for st in stacks:
        where[st] = where.get(st, 0) + 1
    log(f"{label} sync debug mode over {n_steps} steps: {len(stacks)} "
        f"synchronising "
        f"calls, {len(stacks) / n_steps:.2f} per step"
        + "".join(f"\n  {n}x {st}" for st, n in sorted(where.items()))
        + "".join(f"\n  not counted: {m}" for m in notices))
    return len(stacks) / n_steps


def unsup_config(fused: bool, aggregator: str = "mean"):
    """agg_sweep.py's "unsup_mean" (or ``aggregator`` at its width):
    bench.py's model without the head, 20 negatives, dropout 0."""
    from graphsage_tpu_torch.models.unsupervised import UnsupervisedConfig

    return UnsupervisedConfig(
        sage=bench_config(fused, aggregator=aggregator).sage)


def unsup_stream(dev, n_steps: int, seed: int, sets: int | None = None):
    """agg_sweep.py's unsupervised inputs for ``n_steps`` steps: uniform
    pairs [n_steps*512, 2] over the N nodes from numpy ``seed``, and each
    step's 20 negatives drawn from the same generator's uniforms against
    the unigram^0.75 CDF of agg_sweep's degrees (all 128, over the N+1
    ids: the dummy has a share), mapped on the card; with ``sets``, that
    many sets a step ([n_steps, sets, 20], a sharded runner's: its first
    set is the 2-D draw's at ``sets`` 1)."""
    import torch

    from graphsage_tpu_torch.nn.negative import (
        negatives_from_uniforms,
        unigram_cdf,
    )

    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, NUM_NODES, (n_steps * BATCH, 2), dtype=np.int32)
    u = rng.random((n_steps,) + ((sets,) if sets else ()) + (NEG_SAMPLES,),
                   dtype=np.float32)
    cdf = torch.from_numpy(unigram_cdf(np.full(NUM_NODES + 1, MAX_DEGREE)))
    return (torch.from_numpy(pairs).to(dev),
            negatives_from_uniforms(cdf.to(dev), torch.from_numpy(u).to(dev)))


def train_unsupervised(dev, data, chunks: int = 3,
                       chunk_steps: int = TRAIN_CHUNK, n_sync: int = 10,
                       n_profile: int = 5) -> int:
    """agg_sweep.py's "unsup_mean" through the unsupervised chunk runner:
    ``chunks`` timed chunks of ``chunk_steps`` steps, each ended by
    reading the loss, the train MRR and its EMA; returns K1's launches
    over the timed chunks, which must be one per step with no other
    kernel, and each chunk's ms/step. No host synchronisation may fall
    inside a chunk."""
    import torch

    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.parallel.dp import (
        make_unsupervised_chunk_runner,
    )

    features, adj, _ = data
    config = unsup_config(True)
    params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                      config, device=dev)
    optimizer = make_optimizer(UNSUP_LR)
    opt_state = optimizer.init(params)
    run = make_unsupervised_chunk_runner(config, optimizer, BATCH)
    pairs, negs = unsup_stream(
        dev, 5 + chunks * chunk_steps + n_sync + n_profile, seed=5)
    gen = torch.Generator(device=dev).manual_seed(13)
    shadow = torch.full((), -1.0, device=dev)
    step = 0

    def chunk(n):
        nonlocal params, opt_state, shadow, step
        params, opt_state, shadow, loss, mrr = run(
            params, opt_state, shadow, gen, features, adj, pairs, negs,
            step, n)
        step += n
        return loss, mrr

    loss, _ = chunk(5)                       # warm-up
    check(np.isfinite(float(loss)), "non-finite loss in warm-up")

    reset_counts()
    times, reads = [], []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, mrr = chunk(chunk_steps)
        reads.append(torch.stack([loss, mrr, shadow]).tolist())  # print
        times.append(time.perf_counter() - t0)
        lv, mv, sv = reads[-1]
        check(np.isfinite(lv), f"unsupervised: non-finite loss {lv}")
        check(0.0 < mv <= 1.0 and 0.0 < sv <= 1.0,
              f"unsupervised: train MRR {mv} or its EMA {sv} not in (0, 1]")
    counts = launch_counts()
    n_steps = chunks * chunk_steps
    check_counts(counts, "K1", n_steps, "unsupervised training")
    for i, (dt, (lv, mv, sv)) in enumerate(zip(times, reads)):
        log(f"unsupervised mean train chunk {i + 1}: {chunk_steps} steps in "
            f"{dt * 1e3:.2f} ms, {dt / chunk_steps * 1e3:.4f} ms/step, "
            f"{UNSUP_EDGES_PER_STEP * chunk_steps / dt:.1f} edges/s; loss "
            f"{lv:.5f}, train MRR {mv:.5f}, EMA {sv:.5f}")
    log(f"unsupervised mean training: launches {counts} in {n_steps} steps; "
        f"{UNSUP_EDGES_PER_STEP} edges per step")
    syncs = count_syncs("unsupervised mean", lambda: chunk(n_sync), n_sync)
    check(syncs == 0, f"unsupervised training: {syncs} host "
          f"synchronisations per step")
    profile_window(lambda: chunk(n_profile),
                   f"unsupervised mean, {n_profile} training steps")
    return counts["K1"], [dt / chunk_steps * 1e3 for dt in times]


def embed_full_width(dev, data, repeats: int = 2) -> int:
    """The embed sweep over all 100k nodes (weights from seed 0), as the
    trainer's export and ``embed`` run it; returns K1's launches in it,
    which must be one per batch with no other kernel. The rows are
    finite, of unit norm and within 1e-5 of the sweep without the
    kernel (the same samples); then ``repeats`` more sweeps, every
    request one at a time with its rows back on the host, and a profile
    of 20 batches. Also returns the sweeps' nodes/s and the requests'
    p50 and p90 ms."""
    import torch

    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.train.unsupervised import (
        embed_all_nodes,
        make_embed_sweep,
    )

    features, adj, _ = data
    config = unsup_config(True)
    params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                      config, device=dev)
    n_b = -(-NUM_NODES // BATCH)
    ids_all = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids_all[:NUM_NODES] = np.arange(NUM_NODES)
    ids_dev = torch.from_numpy(ids_all).to(dev)
    sweep = make_embed_sweep(config, BATCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    sweep(params, features, adj, ids_dev[:2 * BATCH], gen)      # warm-up

    def export(cfg):
        t0 = time.perf_counter()
        rows = embed_all_nodes(cfg, BATCH, params, features, adj, seed=1)
        return rows, time.perf_counter() - t0

    reset_counts()
    rows, dt = export(config)
    counts = launch_counts()
    log(f"embed sweep: {NUM_NODES} nodes in {n_b} batches of {BATCH}, rows "
        f"on the host: {dt * 1e3:.2f} ms, {NUM_NODES / dt:.1f} nodes/s; "
        f"kernel launches {counts}")
    check_counts(counts, "K1", n_b, "embed sweep")
    check(rows.shape == (NUM_NODES, config.sage.output_dim),
          f"embed rows shape {rows.shape}")
    check(bool(np.isfinite(rows).all()), "non-finite embeddings")
    norm_err = float(np.abs(np.linalg.norm(rows, axis=1) - 1.0).max())
    plain, plain_dt = export(unsup_config(False))
    diff = float(np.abs(rows - plain).max())
    log(f"embed sweep: rows' norm within {norm_err:.3e} of 1 (limit 1e-5); "
        f"with vs without K1, all {NUM_NODES} nodes: max abs diff "
        f"{diff:.3e} (limit 1e-5); the sweep without K1 {plain_dt * 1e3:.2f} "
        f"ms")
    check(norm_err <= 1e-5, f"embedding norms off 1 by {norm_err}")
    check(diff <= 1e-5, f"embed sweep with and without K1 differ by {diff}")
    rates = []
    for rep in range(repeats):
        _, dt_rep = export(config)
        rates.append(NUM_NODES / dt_rep)
        log(f"embed sweep repeat {rep + 1}: {dt_rep * 1e3:.2f} ms, "
            f"{NUM_NODES / dt_rep:.1f} nodes/s")
    lat = []
    for i in range(n_b):
        t1 = time.perf_counter()
        sweep(params, features, adj, ids_dev[i * BATCH:(i + 1) * BATCH],
              gen).cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"embed per request of {BATCH} nodes ({len(lat)} requests): p50 "
        f"{np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} "
        f"ms, max {max(lat):.3f} ms")
    profile_window(lambda: sweep(params, features, adj, ids_dev[:20 * BATCH],
                                 gen), "embed sweep of 20 batches")
    return counts["K1"], {"nodes_per_s": rates,
                          "p50": float(np.percentile(lat, 50)),
                          "p90": float(np.percentile(lat, 90))}


# ------------------------------------------------- phase 5, node2vec

def bench_graph(data):
    """bench.py's zipf adjacency as an undirected graph: each node linked
    both ways to the 128 ids it drew, duplicates and self loops dropped;
    70% of the nodes train, the others are the eval (val and test) nodes,
    from numpy seed 11. Returns (neighbor lists, train-subgraph neighbor
    lists, is_train). The edge keys are deduplicated and sorted on the
    adjacency's device (25.6M of them)."""
    import torch

    dst = data[1][:NUM_NODES].reshape(-1).long()
    src = torch.arange(NUM_NODES, device=dst.device).repeat_interleave(
        MAX_DEGREE)
    keep = src != dst
    key = torch.unique(torch.cat([src[keep] * NUM_NODES + dst[keep],
                                  dst[keep] * NUM_NODES + src[keep]]))
    a = (key // NUM_NODES).cpu().numpy()
    b = (key % NUM_NODES).int().cpu().numpy()
    is_train = np.random.default_rng(11).random(NUM_NODES) < 0.7

    def lists(sel):
        return np.split(b[sel], np.searchsorted(a[sel],
                                                np.arange(1, NUM_NODES)))

    return lists(slice(None)), lists(is_train[a] & is_train[b]), is_train


def native_walks(data) -> dict:
    """The C++ host builder on bench.py's graph: build it, pad the train
    and the full adjacency to 128 and time each, then 10 walks of length
    5 from every train node (timed, pairs/s), and the Python walker on
    2,000 of them beside it. Fails if a NumPy path ran. Returns the graph,
    the train degrees and the walk pairs for node2vec."""
    from graphsage_tpu_torch.data import native
    from graphsage_tpu_torch.data.adjacency import pad_neighbor_lists
    from graphsage_tpu_torch.data.walks import (
        python_random_walks,
        run_random_walks,
    )

    t0 = time.perf_counter()
    check(native.available(), "the C++ host builder did not build or load")
    log(f"native: graph_builder.cpp built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    full, train, is_train = bench_graph(data)
    n_edges = sum(map(len, full)) // 2
    log(f"native: bench.py's graph, {NUM_NODES} nodes, {n_edges} undirected "
        f"edges ({sum(map(len, train)) // 2} among {int(is_train.sum())} "
        f"train nodes), made in {time.perf_counter() - t0:.2f} s")
    calls = (native.native_pad_adjacency.calls,
             native.native_random_walks.calls)
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    train_adj, deg = pad_neighbor_lists(train, NUM_NODES, MAX_DEGREE, rng)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_adj, _ = pad_neighbor_lists(full, NUM_NODES, MAX_DEGREE, rng)
    t_full = time.perf_counter() - t0
    check(train_adj.shape == full_adj.shape == (NUM_NODES + 1, MAX_DEGREE)
          and (full_adj[NUM_NODES] == NUM_NODES).all()
          and (train_adj[:NUM_NODES][~is_train] == NUM_NODES).all(),
          "padded adjacency: bad shape or dummy rows")
    for i in (0, 1, 77, NUM_NODES - 1):
        check(np.isin(full_adj[i], full[i]).all(),
              f"padded row {i} holds ids that are not its neighbors")
    log(f"native: padded adjacency [{NUM_NODES + 1}, {MAX_DEGREE}]: train "
        f"{t_train:.3f} s, full {t_full:.3f} s")
    nodes = np.flatnonzero(is_train)
    walks, walk_len = 10, 5
    t0 = time.perf_counter()
    pairs = run_random_walks(train, nodes, walks, walk_len, rng)
    t_walk = time.perf_counter() - t0
    check((native.native_pad_adjacency.calls,
           native.native_random_walks.calls) == (calls[0] + 2, calls[1] + 1),
          "the padding or the walks took the NumPy path")
    sub = nodes[:2000]
    t0 = time.perf_counter()
    py_pairs = python_random_walks(train, sub, walks, walk_len,
                                   np.random.default_rng(4))
    t_py = time.perf_counter() - t0
    check(len(pairs) > 0 and (pairs[:, 0] != pairs[:, 1]).all()
          and is_train[pairs].all(), "bad walk pairs")
    log(f"native: walks, {walks} of length {walk_len} from each of "
        f"{len(nodes)} train nodes: {len(pairs)} pairs in {t_walk:.3f} s, "
        f"{len(pairs) / t_walk:.1f} pairs/s, "
        f"{len(nodes) * walks * walk_len / t_walk:.1f} walk steps/s; the "
        f"Python walker on {len(sub)} of them: {len(py_pairs)} pairs in "
        f"{t_py:.3f} s, {len(py_pairs) / t_py:.1f} pairs/s, "
        f"{len(sub) * walks * walk_len / t_py:.1f} walk steps/s")
    return {"full": full, "is_train": is_train, "deg": deg, "pairs": pairs,
            "rng": rng}


def train_node2vec(dev, graph: dict, chunks: int = 3,
                   chunk_steps: int = TRAIN_CHUNK, n_sync: int = 10,
                   n_profile: int = 5) -> None:
    """node2vec at the trainer's default width (dim 2 x 128 = 256) over
    bench.py's 100k nodes, batch 512, 20 unique negatives, SGD at lr 2.0,
    on the native walker's pairs, through the chunk runner: ``chunks``
    timed chunks of ``chunk_steps`` steps (each with its negatives drawn
    from host noise, ended by reading loss, train MRR and its EMA), no
    host synchronisation in a chunk, no kernel of K1-K7, a profile; then
    the retrain, two chunks over walks from the eval nodes with every
    other context row frozen (bit-identical after); one step on the card
    against the CPU with the same pairs and negatives; the first chunk's
    negatives on the card equal to the CPU's for one seed. Returns the
    target table's node rows on the host."""
    import torch

    from graphsage_tpu_torch.data.walks import run_random_walks
    from graphsage_tpu_torch.models import node2vec as n2v
    from graphsage_tpu_torch.nn.negative import (
        NOISE_BLOCK_ELEMS,
        sample_negatives_unique,
        unigram_logits,
    )
    from graphsage_tpu_torch.parallel.dp import make_node2vec_chunk_runner
    from graphsage_tpu_torch.train.unsupervised import pad_pairs

    config = n2v.Node2VecConfig(NUM_NODES + 1, N2V_DIM, NEG_SAMPLES, N2V_LR)
    params = n2v.init_node2vec_params(torch.Generator().manual_seed(0),
                                      config, dev)
    optimizer = n2v.make_optimizer(N2V_LR)
    opt_state = optimizer.init(params)
    logits_cpu = unigram_logits(
        np.concatenate([graph["deg"], [0]]).astype(np.float32))
    logits = logits_cpu.to(dev)
    host_rng = np.random.default_rng(12)

    def stream(pairs):
        padded = pad_pairs(pairs, BATCH, NUM_NODES)
        return torch.from_numpy(
            padded[host_rng.permutation(len(padded))]).to(dev)

    pairs_dev = stream(graph["pairs"])
    run = make_node2vec_chunk_runner(config, optimizer, BATCH, NUM_NODES)
    state = {"shadow": torch.full((), -1.0, device=dev), "step": 0}

    def chunk(n, negs=None, runner=run, pairs=pairs_dev, *mask):
        if negs is None:
            negs = sample_negatives_unique(host_rng, logits, NEG_SAMPLES, n)
        _, _, state["shadow"], loss, mrr = runner(
            params, opt_state, state["shadow"], pairs, negs, state["step"], n,
            *mask)
        state["step"] += n
        return loss, mrr

    loss, _ = chunk(5)                                   # warm-up
    check(np.isfinite(float(loss)), "node2vec: non-finite loss in warm-up")
    reset_counts()
    times, reads = [], []
    for _ in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, mrr = chunk(chunk_steps)
        reads.append(torch.stack([loss, mrr, state["shadow"]]).tolist())
        times.append(time.perf_counter() - t0)
        lv, mv, sv = reads[-1]
        check(np.isfinite(lv), f"node2vec: non-finite loss {lv}")
        check(0.0 < mv <= 1.0 and 0.0 < sv <= 1.0,
              f"node2vec: train MRR {mv} or its EMA {sv} not in (0, 1]")
    counts = launch_counts()
    check(not any(counts.values()),
          f"node2vec launched kernels of K1-K7: {counts}")
    for i, (dt, (lv, mv, sv)) in enumerate(zip(times, reads)):
        log(f"node2vec train chunk {i + 1}: {chunk_steps} steps in "
            f"{dt * 1e3:.2f} ms, {dt / chunk_steps * 1e3:.4f} ms/step, "
            f"{BATCH * chunk_steps / dt:.1f} pairs/s (negatives' host "
            f"noise included); loss {lv:.5f}, train MRR {mv:.5f}, EMA "
            f"{sv:.5f}")
    negs = sample_negatives_unique(host_rng, logits, NEG_SAMPLES,
                                   max(n_sync, n_profile))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_noise = sample_negatives_unique(host_rng, logits, NEG_SAMPLES,
                                         chunk_steps)
    torch.cuda.synchronize()
    log(f"node2vec: a chunk's negatives ([{chunk_steps}, {NUM_NODES + 1}] "
        f"float32 host noise, {chunk_steps * (NUM_NODES + 1) * 4 / 1e6:.1f} "
        f"MB copied in blocks of at most {NOISE_BLOCK_ELEMS * 4 / 2**20:g} "
        f"MiB, top {NEG_SAMPLES} on the card) in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    del host_noise
    syncs = count_syncs("node2vec", lambda: chunk(n_sync, negs[:n_sync]),
                        n_sync)
    check(syncs == 0, f"node2vec: {syncs} host synchronisations per step")
    profile_window(lambda: chunk(n_profile, negs[:n_profile]),
                   f"node2vec, {n_profile} training steps")

    # the retrain: walks from the eval nodes over the whole graph, their
    # contexts train nodes (fixed_n2v); only eval nodes' context rows train
    is_train = graph["is_train"]
    walks = run_random_walks(graph["full"], np.flatnonzero(~is_train), 10, 5,
                             graph["rng"])
    retrain_pairs = stream(walks[is_train[walks[:, 1]]])
    update_mask = torch.from_numpy(
        np.append(~is_train, False).astype(np.float32)).to(dev)
    frozen = update_mask == 0
    before = {k: params[k].detach().clone() for k in ("context", "target")}
    retrain = make_node2vec_chunk_runner(config, optimizer, BATCH, NUM_NODES,
                                         with_update_mask=True)
    state.update(shadow=torch.full((), -1.0, device=dev), step=0)
    for _ in range(2):
        loss, _ = chunk(chunk_steps, None, retrain, retrain_pairs,
                        update_mask)
    same = bool(torch.equal(params["context"].detach()[frozen],
                            before["context"][frozen]))
    evalnodes = torch.from_numpy(np.append(~is_train, False)).to(dev)
    moved = (params["target"].detach()[evalnodes]
             != before["target"][evalnodes]).any(dim=1).float().mean().item()
    log(f"node2vec retrain: {2 * chunk_steps} steps, loss {float(loss):.5f}; "
        f"{int(frozen.sum())} frozen context rows bit-identical: {same}; "
        f"eval nodes' target rows moved: {moved:.4f} of them")
    check(same, "node2vec retrain moved a frozen context row")
    check(moved > 0, "node2vec retrain moved no eval node's target row")

    # one step on the card against the plain CPU step
    pair = pairs_dev[:BATCH]
    b1, b2 = pair[:, 0], pair[:, 1]
    mask = (b1 != NUM_NODES).float()
    step_negs = negs[0]
    grads, losses = {}, {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        p = {k: v.detach().to(where).clone().requires_grad_(True)
             for k, v in params.items()}
        loss, _ = n2v.node2vec_loss(p, b1.to(where), b2.to(where),
                                    mask.to(where), step_negs.to(where),
                                    config)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {k: v.grad.cpu() for k, v in p.items()}
        del p
    loss_diff = abs(losses["card"] - losses["cpu"])
    worst = {k: float((grads["card"][k] - grads["cpu"][k]).abs().max())
             for k in grads["cpu"]}
    log(f"node2vec one step, card vs CPU: loss {losses['card']:.6f} vs "
        f"{losses['cpu']:.6f} (diff {loss_diff:.3e}, limit {N2V_TOL}); "
        f"gradients max abs diff {worst} (limit {N2V_TOL})")
    check(loss_diff <= N2V_TOL and max(worst.values()) <= N2V_TOL,
          f"node2vec card vs CPU: loss {loss_diff}, gradients {worst}")

    # the trainer's first chunk of negatives: host noise after the
    # epoch's permutation, from one seed, on both devices
    ids = {}
    for name, lg in (("card", logits), ("cpu", logits_cpu)):
        rng = np.random.default_rng(123)
        rng.permutation(len(pairs_dev))
        ids[name] = sample_negatives_unique(rng, lg, NEG_SAMPLES,
                                            TRAIN_CHUNK).cpu()
    same = bool(torch.equal(ids["card"], ids["cpu"]))
    log(f"node2vec: the first chunk's negatives [{TRAIN_CHUNK}, "
        f"{NEG_SAMPLES}] from seed 123, card equal to CPU: {same}")
    check(same, "node2vec negatives differ between the card and the CPU")
    return params["target"].detach()[:NUM_NODES].cpu().numpy()


def eval_full_width(dev, target: np.ndarray, is_train: np.ndarray,
                    n_profile: int = 200) -> None:
    """``eval``'s classifier at Reddit's scale (``run_regression``, the
    entry point ``evaluate_embeddings`` calls): the node2vec phase's
    256-d target rows of bench.py's ~70k train nodes, 41 classes
    planted from numpy seed 13 (each row's argmax under a random linear
    map, so the fit has a signal to find), scored on the ~30k other
    nodes; EVAL_EPOCHS fixed epochs (``--sgd_max_iter``) on the card and
    on the CPU, then on the CPU with the train rows moved by 1e-15 of
    themselves (a control: how far rounding alone moves the F1s). Logs
    us per sample update and the fit's seconds on each; fails unless the
    card's F1s are within EVAL_F1_TOL of the CPU's, the dummy's equal,
    and the test F1 beats the dummy's. A profile of ``n_profile`` sample
    updates on the card."""
    import torch

    from graphsage_tpu_torch.evaluation import fit_sgd_logistic, run_regression

    rng = np.random.default_rng(13)
    labels = np.argmax(target @ rng.standard_normal(
        (target.shape[1], NUM_CLASSES)), axis=1)
    x_train = target[is_train].astype(np.float64)
    moved = x_train * (1 + 1e-15 * rng.standard_normal(x_train.shape))
    out = {}
    for name, where, x in (("card", dev, x_train),
                           ("CPU", torch.device("cpu"), x_train),
                           ("CPU, X moved by 1e-15", torch.device("cpu"),
                            moved)):
        r = run_regression(x, labels[is_train], target[~is_train],
                           labels[~is_train], seed=1,
                           sgd_max_iter=EVAL_EPOCHS, device=where)
        out[name] = {k: r[k] for k in ("test_f1", "train_f1", "dummy_f1")}
        log(f"eval at full width on the {name}: {len(x)} train rows x "
            f"{target.shape[1]}, {NUM_CLASSES} classes, {EVAL_EPOCHS} "
            f"epochs: {r['fit_updates']} sample updates in "
            f"{r['fit_seconds']:.3f} s, "
            f"{r['fit_seconds'] / r['fit_updates'] * 1e6:.2f} us each; "
            f"F1 test {r['test_f1']!r}, train {r['train_f1']!r}, dummy "
            f"{r['dummy_f1']!r}")
    diff = {k: abs(out["card"][k] - out["CPU"][k]) for k in out["CPU"]}
    control = {k: abs(out["CPU, X moved by 1e-15"][k] - out["CPU"][k])
               for k in out["CPU"]}
    log(f"eval at full width, F1s card vs CPU: {diff} (limit "
        f"{EVAL_F1_TOL}; the dummy's 0); CPU vs CPU with X moved by "
        f"1e-15: {control}")
    check(max(diff["test_f1"], diff["train_f1"]) <= EVAL_F1_TOL
          and diff["dummy_f1"] == 0,
          f"eval F1s differ: card {out['card']}, CPU {out['CPU']}")
    check(out["card"]["test_f1"] > out["card"]["dummy_f1"],
          f"eval found no signal: {out['card']}")
    x = torch.from_numpy(x_train[:n_profile]).to(dev)
    y = torch.from_numpy((labels[is_train][:n_profile, None] == np.arange(
        NUM_CLASSES)).astype(np.float64)).to(dev)
    profile_window(lambda: fit_sgd_logistic(x, y, max_iter=1, tol=None),
                   f"eval, {n_profile} sample updates")


@contextlib.contextmanager
def plain_hop():
    """The model's fused innermost hop through the kernels' plain
    versions: the same Philox masks and the same generator draws, so a
    training step through K2 or K6 can be held to it."""
    from graphsage_tpu_torch.models import graphsage
    from graphsage_tpu_torch.ops.gather import (
        gather_mean_dropout_reference,
        gather_mean_reference,
    )
    from graphsage_tpu_torch.ops.pool import gathered_rows_reference, pool_rows

    def mean(features, idx, drop_rate=0.0, seed=None, offset=None,
             dedup=False):
        if drop_rate > 0.0:
            return gather_mean_dropout_reference(features, idx, drop_rate,
                                                 seed, offset)
        return gather_mean_reference(features, idx)

    def mlp_pool(features, idx, w, b, reduce="max", drop_rate=0.0,
                 seed=None, offset=None):
        return pool_rows(gathered_rows_reference(features, idx, drop_rate,
                                                 seed, offset),
                         w, b, reduce, idx.shape[1])

    saved = graphsage.fused_gather_mean, graphsage.gather_mlp_pool_train
    graphsage.fused_gather_mean, graphsage.gather_mlp_pool_train = (
        mean, mlp_pool)
    try:
        yield
    finally:
        graphsage.fused_gather_mean, graphsage.gather_mlp_pool_train = saved


def unsup_other_routes(dev, data, n: int = 4) -> dict:
    """The slice's other kernel routes, ``n`` launches each, counted from
    0: unsupervised training with dropout 0.5 at lr 1e-5 through K2
    (mean) and K6 (meanpool), the loss finite, after one step through
    each held to the plain path with the same drop key (``plain_hop``):
    the loss within 1e-5, the gradients within GRAD_TOL; and ``n``
    batches of the meanpool embed sweep through K5, within POOL_TOL of
    the sweep without it (the same samples). Returns the launches by
    kernel."""
    import dataclasses

    import torch

    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.parallel.dp import (
        make_unsupervised_chunk_runner,
    )
    from graphsage_tpu_torch.train.unsupervised import make_embed_sweep

    features, adj, _ = data
    pairs, negs = unsup_stream(dev, n, seed=7)
    out = {}
    for aggregator, kernel in (("mean", "K2"), ("meanpool", "K6")):
        config = unsup_config(True, aggregator)
        config = dataclasses.replace(config, sage=dataclasses.replace(
            config.sage, dropout=DROPOUT))

        def train(n_steps, hop):
            """(last loss, its clipped gradients, launches) of
            ``n_steps`` from seeded weights, with ``hop`` entered."""
            params = init_unsupervised_params(
                torch.Generator().manual_seed(0), config, device=dev)
            optimizer = make_optimizer(UNSUP_LR)
            run = make_unsupervised_chunk_runner(config, optimizer, BATCH)
            reset_counts()
            with hop:
                _, _, _, loss, _ = run(
                    params, optimizer.init(params),
                    torch.full((), -1.0, device=dev),
                    torch.Generator(device=dev).manual_seed(3), features,
                    adj, pairs, negs, 0, n_steps, drop_seed=11)
            return (float(loss), {k: p.grad.clone()
                                  for k, p in params.items()},
                    launch_counts())

        what = f"unsupervised {aggregator} training, dropout {DROPOUT}"
        loss_k, grads_k, counts_k = train(1, contextlib.nullcontext())
        loss_p, grads_p, counts_p = train(1, plain_hop())
        check_counts(counts_k, kernel, 1, f"{what}, one step")
        check_counts(counts_p, kernel, 0, f"{what}, one plain step")
        l_diff = abs(loss_k - loss_p)
        g_diff = max(float((grads_k[k] - grads_p[k]).abs().max())
                     for k in grads_k)
        # the worst element's share of assert_close's allowance
        share, name = max(
            (float(((grads_k[k] - grads_p[k]).abs()
                    / (GRAD_TOL["atol"]
                       + GRAD_TOL["rtol"] * grads_p[k].abs())).max()), k)
            for k in grads_k)
        log(f"{what}, one step through {kernel} vs the plain path with the "
            f"same drop key: loss {loss_k:.6f}, diff {l_diff:.3e} (limit "
            f"1e-5); gradients max abs diff {g_diff:.3e}, worst share of "
            f"the allowance atol + rtol |g| {share:.3f} (in {name}; rtol "
            f"{GRAD_TOL['rtol']}, atol {GRAD_TOL['atol']})")
        check(l_diff <= 1e-5, f"{what}: losses differ by {l_diff}")
        for k in grads_k:
            torch.testing.assert_close(grads_k[k], grads_p[k], **GRAD_TOL)
        loss, _, counts = train(n, contextlib.nullcontext())
        check(np.isfinite(loss), f"{aggregator} dropout: bad loss")
        check_counts(counts, kernel, n, what)
        out[kernel] = n
    ids = torch.arange(n * BATCH, dtype=torch.int32, device=dev)
    rows = {}
    for fused in (True, False):
        config = unsup_config(fused, "meanpool")
        params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                          config, device=dev)
        reset_counts()
        rows[fused] = make_embed_sweep(config, BATCH)(
            params, features, adj, ids,
            torch.Generator(device=dev).manual_seed(1))
        counts = launch_counts()
        check_counts(counts, "K5", n if fused else 0,
                     f"meanpool embed sweep, fused {fused}")
    diff = float((rows[True] - rows[False]).abs().max())
    log(f"unsupervised routes: K2 (mean, dropout {DROPOUT}) and K6 "
        f"(meanpool, dropout {DROPOUT}) once per step over {n} steps; "
        f"meanpool embed sweep, {n} batches: K5 once per batch, rows max abs "
        f"diff {diff:.3e} against the sweep without it (limit {POOL_TOL})")
    check(diff <= POOL_TOL, f"meanpool embed rows differ by {diff}")
    out["K5"] = n
    return out


# ------------------------------------------------------------ phase 6

def fused_vs_unfused_training(dev, data, label: str, fused_config,
                              plain_config, kernel: str,
                              p_limit: float | None) -> None:
    """4 steps at dropout 0 from the same weights and generator state,
    through ``kernel`` (``fused_config``: K1 or K3 for mean; K6 forward
    and its autograd backward for meanpool; K4's rows for seq) and
    through the plain gather (``plain_config``): the same samples (the
    sampler's stream is shared), so the first step's gradients agree to
    f32 rounding (1e-5), and so do the 4 losses.

    The params after 4 Adam steps: for mean within ``p_limit`` 1e-4, the
    tolerance of the CPU tests' Adam steps (Adam divides by |g| + eps,
    which amplifies last-bit gradient differences where |g| is near
    eps); for seq 1e-6, since K4's rows are bit-equal to index_select's
    and the rest of the step is the same code. For meanpool no
    per-element bound holds (``p_limit`` None): by steps 3-4 the rounding
    has moved a few of the 2 x 512 MLP units across relu's kink, their
    gradients part, and Adam steps such elements by up to lr whatever
    their size (measured: 108 of 131072 elements of aggs.1.mlp.0.w
    beyond 1e-4, up to 1.6e-3, while the first step's gradients agree to
    9e-10). All are held, per tensor, to a difference of the two runs'
    updates below 1% of the update's norm."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    ids_perm = torch.from_numpy(np.random.default_rng(6).permutation(
        NUM_NODES)[:4 * BATCH].astype(np.int32)).to(dev)
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    out = {}
    for fused, config in ((True, fused_config), (False, plain_config)):
        params = init_supervised_params(torch.Generator().manual_seed(7),
                                        config, device=dev)
        start = {k: v.clone() for k, v in params.items()}
        optimizer = make_optimizer(LEARNING_RATE)
        opt_state = optimizer.init(params)
        run = make_supervised_chunk_runner(config, optimizer, BATCH)
        gen = torch.Generator(device=dev).manual_seed(8)
        reset_counts()
        losses = []
        for i in range(4):
            params, opt_state, loss, _, _ = run(
                params, opt_state, gen, features, adj, ids_perm,
                labels_table, i, 1)
            losses.append(float(loss))
            if i == 0:   # the clipped gradients of the first step
                grads = {k: p.grad.clone() for k, p in params.items()}
        out[fused] = (params, grads, losses, launch_counts())
    hold_fused_to_plain(label, kernel, out, start, p_limit)


def hold_fused_to_plain(label: str, kernel: str, out: dict, start: dict,
                        p_limit: float | None) -> None:
    """``out[fused]`` = (params, first-step grads, losses, launches) of 4
    steps with (True) and without (False) ``kernel`` from the weights
    ``start``: the checks of ``fused_vs_unfused_training``."""
    def max_diff(a, b):
        return max(float((a[k] - b[k]).detach().abs().max()) for k in a)

    g_diff = max_diff(out[True][1], out[False][1])
    p_diff = max_diff(out[True][0], out[False][0])
    l_diff = max(abs(a - b) for a, b in zip(out[True][2], out[False][2]))
    fused_p, plain_p = out[True][0], out[False][0]
    rel = max(float((fused_p[k] - plain_p[k]).detach().norm()
                    / (plain_p[k] - start[k]).detach().norm().clamp(min=1e-30))
              for k in start)
    log(f"{label} with vs without {kernel}, training, 4 steps at dropout 0: "
        f"first-step grads max abs diff {g_diff:.3e} (limit 1e-5), losses "
        f"{l_diff:.3e} (limit 1e-5), params after 4 Adam steps {p_diff:.3e} "
        f"(limit {p_limit or 'none overall, see the docstring'}), update "
        f"difference over update norm, worst tensor {rel:.3e} (limit 1e-2); "
        f"launches {out[True][3]} vs {out[False][3]}")
    check_counts(out[True][3], kernel, 4, f"{label} training with {kernel}")
    check_counts(out[False][3], kernel, 0, f"{label} plain training")
    check(g_diff <= 1e-5, f"fused and unfused gradients differ by {g_diff}")
    check(l_diff <= 1e-5, f"fused and unfused losses differ by {l_diff}")
    check(p_limit is None or p_diff <= p_limit,
          f"fused and unfused params differ by {p_diff}")
    check(rel <= 1e-2, f"fused and unfused updates differ by {rel} of "
          f"their norm")


def hold_params_where_adam_resolves(label: str, out: dict, low: dict,
                                    eps: float,
                                    p_limit: float | None) -> None:
    """Per element, the params of ``out`` (as ``hold_fused_to_plain``
    takes it) after 4 Adam steps. Adam steps an element by lr m/(sqrt(v)
    + eps), so a gradient difference dg moves its step by about lr dg /
    sqrt(v): where ``low``, the smaller sqrt(v) (bias-corrected) of the
    two runs at any step, stays at ADAM_FLOOR x eps (1e-5) or above, a
    dg of 1.6e-8 (the first step's, measured) moves it by at most
    1.6e-3 lr a step, 6.4e-5 in 4 steps at lr 1e-2, and its params are
    held to ``p_limit``; below, a last-bit dg moves the step by a share
    of lr, so those elements are held only by the update-norm rule. Logs the worst element's first-step gradients
    and its sqrt(v) over eps, and how many elements fall below."""
    fused_p, plain_p = out[True][0], out[False][0]
    exempt = exempt_beyond = total = 0
    worst, held_max = (-1.0, None, 0), 0.0
    for k in plain_p:
        diff = (fused_p[k] - plain_p[k]).detach().abs()
        below = low[k] < ADAM_FLOOR * eps
        total += diff.numel()
        exempt += int(below.sum())
        exempt_beyond += int((below & (diff > 1e-4)).sum())
        held_max = max(held_max, float(diff.masked_fill(below, 0.0).max()))
        d = float(diff.max())
        if d > worst[0]:
            worst = (d, k, int(diff.argmax()))
    d, k, j = worst
    g_f = float(out[True][1][k].flatten()[j])
    g_p = float(out[False][1][k].flatten()[j])
    log(f"{label}, params per element after 4 Adam steps: worst {k}[{j}] "
        f"differs by {d:.3e}; its first-step gradients {g_f:.4e} / "
        f"{g_p:.4e} ({abs(g_p) / eps:.2f} eps), its smallest sqrt(v) "
        f"{float(low[k].flatten()[j]) / eps:.2f} eps; {exempt} of {total} "
        f"elements have sqrt(v) below {ADAM_FLOOR:g} eps at some step "
        f"({exempt_beyond} of them differ by more than 1e-4); the others "
        f"differ by at most {held_max:.3e} (limit "
        f"{p_limit or 'none: the update-norm rule'})")
    check(p_limit is None or held_max <= p_limit,
          f"{label}: params where Adam resolves the gradient differ by "
          f"{held_max}")


def fused_vs_unfused_unsup(dev, data, label: str, kernel: str,
                           aggregator: str, p_limit: float | None) -> None:
    """``fused_vs_unfused_training`` for unsupervised training at
    ``aggregator``: 4 steps at dropout 0, Adam at lr 1e-2, with and
    without ``kernel`` (K1 for mean, K6 for meanpool) from the same
    weights, generator state, pairs and negatives (so the same
    samples), held by ``hold_fused_to_plain`` to the losses, the first
    step's gradients and 1% of the update's norm, and per element by
    ``hold_params_where_adam_resolves`` to ``p_limit`` (mean 1e-4;
    meanpool None, as in ``fused_vs_unfused_training``). The
    unsupervised loss leaves gradient elements near Adam's eps, whose
    steps last-bit gradient differences move by a share of lr (mean
    before that rule: 1.1e-4 after 4 steps, first-step gradients within
    1.6e-8)."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        ClippedAdam,
        make_optimizer,
    )
    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.parallel.dp import (
        make_unsupervised_chunk_runner,
    )

    features, adj, _ = data
    pairs, negs = unsup_stream(dev, 4, seed=6)
    out = {}
    low = {}     # the smallest bias-corrected sqrt(v) of either run
    for fused in (True, False):
        config = unsup_config(fused, aggregator)
        params = init_unsupervised_params(torch.Generator().manual_seed(7),
                                          config, device=dev)
        start = {k: v.clone() for k, v in params.items()}
        optimizer = make_optimizer(LEARNING_RATE)
        opt_state = optimizer.init(params)
        run = make_unsupervised_chunk_runner(config, optimizer, BATCH)
        gen = torch.Generator(device=dev).manual_seed(8)
        shadow = torch.full((), -1.0, device=dev)
        reset_counts()
        losses = []
        for i in range(4):
            params, opt_state, shadow, loss, _ = run(
                params, opt_state, shadow, gen, features, adj, pairs, negs,
                i, 1)
            losses.append(float(loss))
            if i == 0:
                grads = {k: p.grad.clone() for k, p in params.items()}
            nu = ClippedAdam.state_dict(opt_state, params)["nu"]
            for k, v in nu.items():
                s = (v / (1 - optimizer.b2 ** (i + 1))).sqrt()
                low[k] = s if k not in low else torch.minimum(low[k], s)
        out[fused] = (params, grads, losses, launch_counts())
    hold_fused_to_plain(label, kernel, out, start, None)
    hold_params_where_adam_resolves(label, out, low, optimizer.eps, p_limit)


# ------------------------------------------------------------ phase 7

def predict_job(dev, tmp: str, extra: dict):
    """(label, command, finish) of ``python -m graphsage_tpu_torch
    predict`` on the card; ``finish(rc, stdout, stderr)`` checks it
    against the CPU path on the same checkpoint (first_k sampling).
    ``extra``: boolean flags set on both, e.g. {"dedup_gather": True}."""
    import torch

    from graphsage_tpu_torch.data.io import load_data
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )
    from graphsage_tpu_torch.infer import predict
    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.train import checkpoint
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.supervised import build_supervised_config

    label = " ".join(["predict CLI"] + [f"--{k}" for k in extra])
    prefix = os.path.join(tmp, "toy", "toy")
    write_dataset(make_synthetic_graph(num_nodes=300, num_classes=5,
                                       feat_dim=32, seed=3), prefix)
    flags = TrainFlags(train_prefix=prefix, samples_1=5, samples_2=4,
                       dim_1=16, dim_2=16, max_degree=12, batch_size=64,
                       sampler_mode="first_k",
                       checkpoint_dir=os.path.join(tmp, "ckpt"), **extra)
    config = build_supervised_config(flags, load_data(prefix))
    checkpoint.save(flags.checkpoint_dir, init_supervised_params(
        torch.Generator().manual_seed(0), config), 1)
    out_dir = os.path.join(tmp, "preds")
    cmd = [sys.executable, "-m", "graphsage_tpu_torch", "predict",
           "--train_prefix", prefix, "--checkpoint_dir",
           flags.checkpoint_dir, "--samples_1", "5", "--samples_2", "4",
           "--dim_1", "16", "--dim_2", "16", "--max_degree", "12",
           "--batch_size", "64", "--sampler_mode", "first_k",
           "--nodes", "all", "--out_dir", out_dir,
           "--device", str(dev)] + [f"--{k}" for k in extra]

    def finish(rc: int, stdout: str, stderr: str) -> None:
        log(stdout.strip())
        check(rc == 0, f"{label} exited {rc}: {stderr[-2000:]}")
        for name in ("preds.npy", "nodes.txt"):
            check(os.path.exists(os.path.join(out_dir, name)),
                  f"{label} wrote no {name}")
        preds = np.load(os.path.join(out_dir, "preds.npy"))
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = predict(flags, out_dir=os.path.join(tmp, "cpu"),
                          nodes="all", device="cpu")
        cpu_preds = np.load(os.path.join(cpu["out_dir"], "preds.npy"))
        diff = float(np.abs(preds - cpu_preds).max())
        log(f"{label} on {dev} vs CPU: preds {preds.shape}, max abs diff "
            f"{diff:.3e} (limit 1e-5)")
        check(preds.shape == (300, 5), f"preds shape {preds.shape}")
        check(diff <= 1e-5, f"card and CPU predictions differ by {diff}")

    return label, cmd, finish


def supervised_job(dev, tmp: str, model: str, extra: dict,
                   profile: bool = False):
    """(label, command, finish) of ``python -m graphsage_tpu_torch
    supervised`` on the card; ``finish(rc, stdout, stderr)`` runs the
    same training on the CPU: first_k sampling and dropout 0 leave no
    random draw on the device, so the logged losses agree. ``extra``:
    boolean flags set on both, e.g. {"rows_gather": True}. ``profile``:
    the card run takes ``--profile_dir``, whose Chrome trace must name
    the gather-mean kernel (K1 or K2)."""
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.supervised import train

    label = " ".join(["supervised CLI --model", model]
                     + [f"--{k}" for k in extra])
    prefix = os.path.join(tmp, "toy", "toy")
    write_dataset(make_synthetic_graph(num_nodes=400, num_classes=5,
                                       feat_dim=32, seed=3), prefix)
    args = dict(samples_1=5, samples_2=4, dim_1=16, dim_2=16,
                max_degree=12, batch_size=32, epochs=3, print_every=2,
                validate_iter=3, validate_batch_size=16,
                sampler_mode="first_k", dropout=0.0, seed=9)
    cmd = [sys.executable, "-m", "graphsage_tpu_torch", "supervised",
           "--train_prefix", prefix, "--base_log_dir",
           os.path.join(tmp, "card"), "--device", str(dev),
           "--model", model]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]
    cmd += [f"--{k}" for k in extra]
    profile_dir = os.path.join(tmp, "profile")
    if profile:
        label += " --profile_dir"
        cmd += ["--profile_dir", profile_dir]

    def logged(base):
        log_dir = os.path.join(base, "sup-toy", f"{model}_small_0.0100")
        for name in ("val_stats.txt", "test_stats.txt"):
            check(os.path.exists(os.path.join(log_dir, name)),
                  f"no {name} in {log_dir}")
        with open(os.path.join(log_dir, "metrics.jsonl")) as fp:
            recs = [json.loads(line) for line in fp]
        return ([r["train_loss"] for r in recs if "train_loss" in r],
                recs[-1]["final_val_loss"])

    def finish(rc: int, stdout: str, stderr: str) -> None:
        log("\n".join(stdout.strip().splitlines()[-3:]))
        check(rc == 0, f"{label} exited {rc}: {stderr[-2000:]}")
        flags = TrainFlags(train_prefix=prefix, model=model,
                           base_log_dir=os.path.join(tmp, "cpu"), **args,
                           **extra)
        with contextlib.redirect_stdout(io.StringIO()):
            train(flags, device="cpu")
        card_losses, card_val = logged(os.path.join(tmp, "card"))
        cpu_losses, cpu_val = logged(os.path.join(tmp, "cpu"))
        check(len(card_losses) == len(cpu_losses) > 0,
              f"{len(card_losses)} vs {len(cpu_losses)} logged losses")
        diff = max(abs(a - b) for a, b in zip(card_losses + [card_val],
                                              cpu_losses + [cpu_val]))
        log(f"{label} on {dev} vs CPU: {len(card_losses)} train losses and "
            f"the final val loss, max abs diff {diff:.3e} (limit "
            f"{CLI_TOL}); first/last train loss {card_losses[0]:.5f}/"
            f"{card_losses[-1]:.5f}, val {card_val:.5f}")
        check(diff <= CLI_TOL, f"card and CPU training differ by {diff}")
        if extra.get("log_histograms"):
            for base in ("card", "cpu"):
                path = os.path.join(tmp, base, "sup-toy",
                                    f"{model}_small_0.0100",
                                    "histograms.jsonl")
                with open(path) as fp:
                    names = {json.loads(line)["name"] for line in fp}
                log(f"{label}: {base} histograms of {len(names)} tensors")
                check({"params/head.w", "acts/layer_0/hop_0"} <= names,
                      f"{path} lacks a histogram")
        if profile:
            (trace,) = os.listdir(profile_dir)
            with open(os.path.join(profile_dir, trace)) as fp:
                events = json.load(fp)["traceEvents"]
            gathers = sorted({e["name"] for e in events
                              if "gather_mean" in e.get("name", "")
                              and e.get("cat") == "kernel"})
            log(f"{label}: trace {trace}, {len(events)} events; its "
                f"gather-mean kernels: {gathers}")
            check(gathers, "the profile trace names no gather-mean kernel")

    return label, cmd, finish


def walks_dataset(tmp: str) -> str:
    """A small synthetic dataset and its walks file, written by
    ``python -m graphsage_tpu_torch walks`` (on the host); returns the
    dataset's prefix."""
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )

    prefix = os.path.join(tmp, "toy", "toy")
    write_dataset(make_synthetic_graph(num_nodes=400, num_classes=5,
                                       feat_dim=32, seed=3), prefix)
    proc = subprocess.run(
        [sys.executable, "-m", "graphsage_tpu_torch", "walks",
         prefix + "-G.json", prefix + "-walks.txt", "--num_walks", "5",
         "--seed", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    log(f"walks CLI: {proc.stdout.strip()}")
    check(proc.returncode == 0, f"walks CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return prefix


def unsupervised_job(dev, tmp: str, prefix: str, model: str):
    """(label, command, finish) of ``python -m graphsage_tpu_torch
    unsupervised`` on the card, on the walk pairs of ``prefix``;
    ``finish(rc, stdout, stderr)`` starts ``embed`` on the card from the
    run's checkpoint, runs the same training on the CPU meanwhile
    (first_k sampling, dropout 0, negatives drawn on the host: no random
    draw differs), then holds every logged loss, MRR and EMA to the
    CPU's within CLI_TOL, val.npy within 1e-4, and embed's val.npy to
    the card run's bit for bit."""
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.unsupervised import train

    label = f"unsupervised CLI --model {model}"
    model_args = dict(samples_1=5, samples_2=4, dim_1=16, dim_2=16,
                      max_degree=12, batch_size=64, neg_sample_size=10,
                      learning_rate=1e-3, sampler_mode="first_k", seed=9)
    train_args = dict(max_total_steps=19, print_every=5, validate_iter=5,
                      validate_batch_size=32, dropout=0.0)
    args = {**model_args, **train_args}
    card_ck = os.path.join(tmp, "ck")

    def command(subcommand, flag_values, *extra):
        cmd = [sys.executable, "-m", "graphsage_tpu_torch", subcommand,
               "--train_prefix", prefix, "--device", str(dev), "--model",
               model, "--checkpoint_dir", card_ck, *extra]
        for k, v in flag_values.items():
            cmd += [f"--{k}", str(v)]
        return cmd

    cmd = command("unsupervised", args, "--base_log_dir",
                  os.path.join(tmp, "card"))
    embed_out = os.path.join(tmp, "embed")
    embed_cmd = command("embed", model_args, "--out_dir", embed_out)

    def logged(base):
        log_dir = os.path.join(base, "unsup-toy", f"{model}_small_0.001000")
        with open(os.path.join(log_dir, "metrics.jsonl")) as fp:
            recs = [json.loads(line) for line in fp]
        keys = ("train_loss", "train_mrr", "train_mrr_ema", "val_loss",
                "val_mrr", "val_mrr_ema")
        return ([[r[k] for k in keys] for r in recs],
                np.load(os.path.join(log_dir, "val.npy")))

    def finish(rc: int, stdout: str, stderr: str) -> None:
        log("\n".join(stdout.strip().splitlines()[-3:]))
        check(rc == 0, f"{label} exited {rc}: {stderr[-2000:]}")
        embed = subprocess.Popen(embed_cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            flags = TrainFlags(train_prefix=prefix, model=model,
                               base_log_dir=os.path.join(tmp, "cpu"),
                               **args)
            with contextlib.redirect_stdout(io.StringIO()):
                train(flags, device="cpu")
            e_out, e_err = embed.communicate(timeout=600)
        finally:
            if embed.poll() is None:
                embed.kill()
                embed.communicate()
        card_recs, card_rows = logged(os.path.join(tmp, "card"))
        cpu_recs, cpu_rows = logged(os.path.join(tmp, "cpu"))
        check(len(card_recs) == len(cpu_recs) > 0,
              f"{len(card_recs)} vs {len(cpu_recs)} logged records")
        diff = float(np.abs(np.array(card_recs) - np.array(cpu_recs)).max())
        rows_diff = float(np.abs(card_rows - cpu_rows).max())
        log(f"{label} on {dev} vs CPU: {len(card_recs)} records of train "
            f"loss, MRR and EMA and val loss, MRR and EMA, max abs diff "
            f"{diff:.3e} (limit {CLI_TOL}); val.npy {card_rows.shape} max "
            f"abs diff {rows_diff:.3e} (limit 1e-4); first/last train loss "
            f"{card_recs[0][0]:.5f}/{card_recs[-1][0]:.5f}, last val MRR "
            f"{card_recs[-1][4]:.5f}")
        check(diff <= CLI_TOL, f"card and CPU training differ by {diff}")
        check(rows_diff <= 1e-4, f"card and CPU val.npy differ by "
              f"{rows_diff}")
        log(e_out.strip())
        check(embed.returncode == 0, f"embed CLI exited {embed.returncode}: "
              f"{e_err[-2000:]}")
        same = np.array_equal(np.load(os.path.join(embed_out, "val.npy")),
                              card_rows)
        log(f"embed CLI --model {model} on {dev} from the card run's "
            f"checkpoint reproduces its val.npy bit for bit: {same}")
        check(same, "embed did not reproduce the trainer's val.npy")

    return label, cmd, finish


def f1s(stdout: str) -> dict:
    """The F1 lines the eval subcommand prints."""
    out = {}
    for line in stdout.splitlines():
        if "F1" in line and ":" in line:
            key, value = line.rsplit(":", 1)
            out[key.strip()] = float(value.split()[0])
    return out


def n2v_job(dev, tmp: str, prefix: str):
    """(label, command, finish) of ``python -m graphsage_tpu_torch
    unsupervised --model n2v --save_embeddings`` on the card, on the walk
    pairs of ``prefix``; ``finish(rc, stdout, stderr)`` runs the same
    training on the CPU (negatives from the same host noise: no random
    draw differs), holds every logged loss, MRR and EMA to the CPU's
    within CLI_TOL and val.npy and val-test.npy within 1e-5, then scores
    the card run's embeddings with ``eval`` on the card and on the CPU:
    the same F1s."""
    from graphsage_tpu_torch.evaluation import evaluate_embeddings
    from graphsage_tpu_torch.train.config import TrainFlags
    from graphsage_tpu_torch.train.unsupervised import train

    label = "unsupervised CLI --model n2v --save_embeddings"
    args = dict(dim_1=16, batch_size=64, neg_sample_size=10,
                learning_rate=N2V_LR, epochs=2, print_every=5,
                n2v_test_epochs=2, seed=9)
    cmd = [sys.executable, "-m", "graphsage_tpu_torch", "unsupervised",
           "--train_prefix", prefix, "--model", "n2v", "--save_embeddings",
           "--base_log_dir", os.path.join(tmp, "card"), "--device",
           str(dev)]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]

    def logged(base):
        log_dir = os.path.join(base, "unsup-toy", "n2v_small_2.000000")
        with open(os.path.join(log_dir, "metrics.jsonl")) as fp:
            recs = [[r[k] for k in ("train_loss", "train_mrr",
                                    "train_mrr_ema")]
                    for r in map(json.loads, fp)]
        return log_dir, recs, [np.load(os.path.join(log_dir, name))
                               for name in ("val.npy", "val-test.npy")]

    def finish(rc: int, stdout: str, stderr: str) -> None:
        log("\n".join(stdout.strip().splitlines()[-2:]))
        check(rc == 0, f"{label} exited {rc}: {stderr[-2000:]}")
        card_dir, card_recs, card_rows = logged(os.path.join(tmp, "card"))
        evals = subprocess.Popen(
            [sys.executable, "-m", "graphsage_tpu_torch", "eval", prefix,
             card_dir, "test", "--device", str(dev)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            flags = TrainFlags(train_prefix=prefix, model="n2v",
                               base_log_dir=os.path.join(tmp, "cpu"),
                               **args)
            with contextlib.redirect_stdout(io.StringIO()):
                train(flags, device="cpu")
            cpu_out = io.StringIO()
            with contextlib.redirect_stdout(cpu_out):
                evaluate_embeddings(prefix, card_dir, "test", device="cpu")
            e_out, e_err = evals.communicate(timeout=600)
        finally:
            if evals.poll() is None:
                evals.kill()
                evals.communicate()
        _, cpu_recs, cpu_rows = logged(os.path.join(tmp, "cpu"))
        check(len(card_recs) == len(cpu_recs) > 0,
              f"{len(card_recs)} vs {len(cpu_recs)} logged records")
        diff = float(np.abs(np.array(card_recs) - np.array(cpu_recs)).max())
        rows_diff = [float(np.abs(a - b).max())
                     for a, b in zip(card_rows, cpu_rows)]
        log(f"{label} on {dev} vs CPU: {len(card_recs)} records of train "
            f"loss, MRR and EMA, max abs diff {diff:.3e} (limit {CLI_TOL}); "
            f"val.npy {card_rows[0].shape} and val-test.npy max abs diff "
            f"{rows_diff[0]:.3e} and {rows_diff[1]:.3e} (limit 1e-5); "
            f"first/last train loss {card_recs[0][0]:.5f}/"
            f"{card_recs[-1][0]:.5f}")
        check(diff <= CLI_TOL, f"card and CPU node2vec differ by {diff}")
        check(max(rows_diff) <= 1e-5, f"card and CPU embeddings differ by "
              f"{rows_diff}")
        check(evals.returncode == 0, f"eval CLI exited {evals.returncode}: "
              f"{e_err[-2000:]}")
        card_f1, cpu_f1 = f1s(e_out), f1s(cpu_out.getvalue())
        log(f"eval CLI on {dev}: {e_out.strip()}")
        log(f"eval on the CPU: {cpu_out.getvalue().strip()}")
        check(card_f1 == cpu_f1 and len(card_f1) == 3,
              f"eval F1s differ: card {card_f1}, CPU {cpu_f1}")

    return label, cmd, finish


# ----------------------------------------- the sharded path (phase 5b)

SHARDED_EQ_STEPS = 5    # steps held to the single-device runner


def first_k(config):
    """``config`` with the deterministic first_k sampler: no draws, so two
    paths sample alike."""
    import dataclasses

    return dataclasses.replace(config, sage=dataclasses.replace(
        config.sage, sampler_mode="first_k"))


def bench_stream(seed: int) -> np.ndarray:
    """A shuffled epoch of every node, padded with the dummy to whole
    batches (the trainer's id stream)."""
    n_b = -(-NUM_NODES // BATCH)
    ids = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
    ids[:NUM_NODES] = np.arange(NUM_NODES)
    return ids[np.random.default_rng(seed).permutation(len(ids))]


def eq_run(dev, data, make_run) -> tuple:
    """``SHARDED_EQ_STEPS`` single steps of bench.py's model (first_k,
    dropout 0, weights from seed 0) through the runner that
    ``make_run(config, optimizer)`` gives, on the epoch stream of seed 4:
    (losses, params, (params, Adam's nu) after the first step, the last
    step's outputs)."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    config = first_k(bench_config(True))
    ids_perm = torch.from_numpy(bench_stream(4)).to(dev)
    params = init_supervised_params(torch.Generator().manual_seed(0),
                                    config, device=dev)
    optimizer = make_optimizer(LEARNING_RATE)
    opt_state = optimizer.init(params)
    run = make_run(config, optimizer)
    losses = []
    gen = torch.Generator(device=dev).manual_seed(5)
    for step in range(SHARDED_EQ_STEPS):
        res = run(params, opt_state, gen, features, adj, ids_perm,
                  labels_table, step, 1)
        losses.append(float(res[2]))
        if step == 0:   # copies: the step updates in place
            first = ({k: v.detach().cpu().clone().numpy()
                      for k, v in params.items()},
                     {k: v.cpu().clone() for k, v in optimizer.state_dict(
                         opt_state, params)["nu"].items()})
    return losses, params, first, res


def single_device_reference(dev, data) -> dict:
    """The single-device runner's ``eq_run``, packed for the multi-rank
    phases: the stream, every step's loss, the last ids, the params and
    sqrt of Adam's bias-corrected nu after the first step, and the
    initial weights."""
    import torch

    from graphsage_tpu_torch.models.supervised import init_supervised_params
    from graphsage_tpu_torch.parallel.dp import make_supervised_chunk_runner

    losses, params, (first_params, first_nu), res = eq_run(
        dev, data, lambda config, opt: make_supervised_chunk_runner(
            config, opt, BATCH))
    config = first_k(bench_config(True))
    return {"ids": bench_stream(4), "losses": losses,
            "last_ids": res[4].cpu().numpy(), "params": first_params,
            "root_nu": {k: (v / (1 - 0.999)).sqrt().numpy()
                        for k, v in first_nu.items()},
            "init": {k: v.cpu().numpy() for k, v in init_supervised_params(
                torch.Generator().manual_seed(0), config).items()},
            "config": config, "final": params}


@contextlib.contextmanager
def one_rank_group(dev):
    """A world-size-1 process group in this process (NCCL on the card,
    gloo on the CPU) for the length of the block; yields its Grid."""
    import shutil

    import torch.distributed as dist

    from graphsage_tpu_torch.parallel.distributed import (
        init_distributed,
        make_grid,
    )

    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    store = tempfile.mkdtemp(dir=scratch)
    init_distributed(f"file://{store}/store", 1, 0, dev)
    try:
        want = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == want,
              f"backend {dist.get_backend()}, expected {want}")
        yield make_grid(1, 1)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def sharded_one_rank(dev, card_line: str, data) -> dict:
    """bench.py's model through the graph-sharded stack on a world-size-1
    NCCL group in this process (``parallel/graph_sharded.py``): the
    chunk runner against the single-device runner (first_k, dropout 0:
    equal losses, bit-equal params), three timed chunks of 50 steps at
    dropout 0.5 (K2 once per step, nothing dropped), and the sharded
    eval sweep over every node against the single-device sweep (K1 once
    per batch, equal predictions; with dedup_gather K3 once per batch,
    within 1e-5). Returns the launch counts, and the equality run for
    the two-rank phase."""
    import torch

    from graphsage_tpu_torch.models.supervised import (
        init_supervised_params,
        make_optimizer,
    )
    from graphsage_tpu_torch.parallel.distributed import fold_seed, host_array
    from graphsage_tpu_torch.parallel.graph_sharded import (
        make_sharded_supervised_chunk_runner,
        make_sharded_supervised_eval_sweep,
        reassemble_sharded_rows,
    )
    from graphsage_tpu_torch.train.supervised import (
        _run_eval_sweep as run_eval_sweep,
    )
    from graphsage_tpu_torch.train.supervised import (
        labels_table_of,
        make_eval_sweep,
    )

    features, adj, labels_np = data
    labels_table = torch.from_numpy(labels_table_of(labels_np,
                                                    NUM_NODES)).to(dev)
    out = {}
    with one_rank_group(dev) as grid:
        # 1. the chunk runner against the single-device runner
        eq = single_device_reference(dev, data)
        losses, params, _, res = eq_run(
            dev, data, lambda config, opt:
                make_sharded_supervised_chunk_runner(config, opt, grid,
                                                     BATCH))
        unequal = [k for k in params
                   if not torch.equal(params[k], eq["final"][k])]
        log(f"sharded D=1 vs the single-device runner, {SHARDED_EQ_STEPS} "
            f"steps (first_k, dropout 0): losses {losses} vs "
            f"{eq['losses']}; params not bit-equal: {unequal or 'none'}; "
            f"dropped {int(res[5])}")
        check(losses == eq["losses"],
              "sharded D=1 and single-device losses differ")
        check(not unequal, f"sharded D=1 params differ from the "
              f"single-device runner's in {unequal}")
        check(int(res[5]) == 0, "requests dropped at D=1")
        del eq["final"], params
        out["eq"] = eq
        ids_perm = torch.from_numpy(eq["ids"]).to(dev)

        # 2. timed training at dropout 0.5: K2 once per step
        config = bench_config(True, DROPOUT)
        params = init_supervised_params(torch.Generator().manual_seed(0),
                                        config, device=dev)
        optimizer = make_optimizer(LEARNING_RATE)
        opt_state = optimizer.init(params)
        run = make_sharded_supervised_chunk_runner(config, optimizer, grid,
                                                   BATCH)
        gen = torch.Generator(device=dev).manual_seed(fold_seed(5, grid.me))
        state = {"step": 0, "dropped": 0}

        def chunk(n):
            nonlocal params, opt_state
            params, opt_state, loss, _, _, dropped = run(
                params, opt_state, gen, features, adj, ids_perm,
                labels_table, state["step"], n, drop_seed=7)
            state["step"] += n
            return loss, dropped

        chunk(5)                               # warm-up
        reset_counts()
        times, losses, dropped_total = [], [], 0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, dropped = chunk(TRAIN_CHUNK)
            losses.append(float(loss))         # the print boundary
            times.append(time.perf_counter() - t0)
            dropped_total += int(dropped)
            check(np.isfinite(losses[-1]), f"non-finite loss {losses[-1]}")
        counts = launch_counts()
        check_counts(counts, "K2", 3 * TRAIN_CHUNK, "sharded D=1 training")
        check(dropped_total == 0, f"{dropped_total} requests dropped")
        for i, (dt, lv) in enumerate(zip(times, losses)):
            log(f"sharded D=1 mean train chunk {i + 1}: {TRAIN_CHUNK} steps "
                f"in {dt * 1e3:.2f} ms, {dt / TRAIN_CHUNK * 1e3:.4f} ms/step"
                f", {EDGES_PER_STEP * TRAIN_CHUNK / dt:.1f} edges/s, loss "
                f"{lv:.5f} ({card_line})")
        log(f"sharded D=1 training: launches {counts} in "
            f"{3 * TRAIN_CHUNK} steps; dropped requests {dropped_total}")
        out["K2"] = counts["K2"]
        count_syncs("sharded D=1 mean", lambda: chunk(10), 10)
        profile_window(lambda: chunk(5), "sharded D=1, 5 training steps")
        del params, opt_state

        # 3. the sharded eval sweep against the single-device sweep
        nodes = np.arange(NUM_NODES)
        n_b = -(-NUM_NODES // BATCH)
        ids_all = np.full((n_b * BATCH,), NUM_NODES, dtype=np.int32)
        ids_all[:NUM_NODES] = nodes
        ids_all = torch.from_numpy(ids_all).to(dev)
        params = init_supervised_params(torch.Generator().manual_seed(0),
                                        bench_config(True), device=dev)
        for _ in range(2):   # warm-up, then timed
            single_loss, single_preds, _, single_dt = run_eval_sweep(
                make_eval_sweep(bench_config(True), BATCH, NUM_NODES),
                params, features, adj, nodes, labels_np, BATCH, NUM_NODES,
                torch.Generator(device=dev).manual_seed(1))
        log(f"single-device mean sweep beside it: {single_dt * 1e3:.2f} ms, "
            f"{NUM_NODES / single_dt:.1f} nodes/s ({card_line})")
        sweeps = {}
        for label, config, kernel in (
                ("mean", bench_config(True), "K1"),
                ("mean dedup_gather", bench_config(True, dedup=True), "K3")):
            sweep = make_sharded_supervised_eval_sweep(config, grid, BATCH)
            sweep(params, features, adj, ids_all[:2 * BATCH], labels_table,
                  torch.Generator(device=dev).manual_seed(1))  # warm-up
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, preds, dropped = sweep(
                params, features, adj, ids_all, labels_table,
                torch.Generator(device=dev).manual_seed(1))
            preds = reassemble_sharded_rows(host_array(preds), 1,
                                            n_b)[:NUM_NODES]
            dt = time.perf_counter() - t0
            counts = launch_counts()
            check_counts(counts, kernel, n_b,
                         f"sharded D=1 {label} serving sweep")
            check(int(dropped) == 0, f"{int(dropped)} requests dropped")
            loss = float(np.mean(losses.cpu().numpy()))
            diff = float(np.abs(preds - single_preds).max())
            log(f"sharded D=1 {label} sweep: {NUM_NODES} nodes in {n_b} "
                f"batches, {dt * 1e3:.2f} ms, {NUM_NODES / dt:.1f} nodes/s "
                f"({card_line}); launches {counts}; loss {loss:.6f} vs "
                f"single-device {single_loss:.6f}; predictions max abs diff "
                f"{diff:.3e} vs the single-device K1 sweep")
            sweeps[kernel] = (loss, preds)
            out[kernel] = counts[kernel]
        check(np.array_equal(sweeps["K1"][1], single_preds)
              and sweeps["K1"][0] == single_loss,
              "the sharded D=1 sweep's predictions are not the "
              "single-device sweep's")
        dedup_diff = float(np.abs(sweeps["K3"][1] - single_preds).max())
        check(dedup_diff <= 1e-5, f"the K3 sweep differs by {dedup_diff}")
    return out


def sharded_ranks(card_line: str, data, eq: dict, devices: list,
                  backend: str, grid: tuple) -> None:
    """Ranks on ``devices`` over ``backend``, spawned through
    ``parallel/launch.py``, in a ``grid`` = (graph_shards, data_shards):
    the exchange's bucketing, scatters and the split mean run on the card
    at bench.py's width. On the one card of the main path: two gloo ranks
    (NCCL puts no two ranks on one device), the collectives through the
    host. The runner's ``SHARDED_EQ_STEPS`` steps (first_k, dropout 0,
    an exact capacity) are held to the single-device runner's ``eq``
    (``single_device_reference``): each
    step's loss rtol 1e-5, the last ids equal, nothing dropped, the
    ranks' params bit-equal; the params after the first step rtol 2e-4 /
    atol 1e-6 where Adam's sqrt(v) is 1e3 eps or more (the elements
    below are counted). Later steps' params are not held element by
    element: an element whose gradient is near eps steps by a share of
    lr that last-bit differences set, and at this width that moves a
    few other elements' later gradients by a share of a percent. Then
    10 timed steps (first_k, dropout 0), and 4 steps at dropout
    ``DROPOUT`` (the split mean's two Philox masks, the plain dropouts;
    other masks than one device's, so held to properties: finite losses,
    equal on the ranks, the params bit-equal across the ranks, nothing
    dropped), 3 of them timed."""
    import dataclasses
    import shutil

    import torch

    from graphsage_tpu_torch.parallel import launch
    from graphsage_tpu_torch.train.supervised import labels_table_of

    features, adj, labels_np = data
    label = (f"sharded {grid[0]} x {grid[1]} on {len(devices)} ranks "
             f"({backend})")
    job = dict(kind="train", grid=grid, runner="sharded",
               sup_config=eq["config"], params=eq["init"],
               features=features.cpu().numpy(), adj=adj.cpu().numpy(),
               ids_perm=eq["ids"],
               labels_table=labels_table_of(labels_np, NUM_NODES),
               batch_size=BATCH, lr=LEARNING_RATE,
               capacity_factor=float(grid[0]),   # exact: nothing drops
               chunks=[(s, 1) for s in range(SHARDED_EQ_STEPS)])
    jobs = {"eq": job, "first": dict(job, chunks=[(0, 1)]),
            "timed": dict(job, chunks=[(0, 2), (2, 10)]),
            "dropout": dict(job, sup_config=dataclasses.replace(
                eq["config"], sage=dataclasses.replace(
                    eq["config"].sage, dropout=DROPOUT)), drop_seed=7,
                chunks=[(0, 1), (1, 3)])}
    scratch = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        torch.save(jobs, os.path.join(scratch, "jobs.pt"))
        del jobs, job
        t0 = time.perf_counter()
        launch.spawn(launch.check_rank,
                     (os.path.join(scratch, "jobs.pt"), scratch), devices,
                     f"file://{scratch}/store", backend=backend,
                     timeout_s=600)
        log(f"{label}: {time.perf_counter() - t0:.2f} s, start-up included")
        outs = [torch.load(os.path.join(scratch, f"rank{r}.pt"),
                           weights_only=False) for r in range(len(devices))]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    chunks = [o["eq"]["chunks"] for o in outs]
    losses = [c["loss"] for c in chunks[0]]
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses, eq["losses"]))
    ids = np.concatenate([c[-1]["ids"] for c in chunks])
    dropped = sum(c["dropped"] for rank in chunks for c in rank)
    held = loose = total = 0
    worst_loose = 0.0
    for k, want in eq["params"].items():
        got = outs[0]["first"]["params"][k]
        for job in ("eq", "first"):
            for o in outs[1:]:
                check(np.array_equal(o[job]["params"][k],
                                     outs[0][job]["params"][k]),
                      f"the ranks' {k} differ")
        resolved = eq["root_nu"][k] >= ADAM_FLOOR * 1e-8
        excess = np.abs(got - want) - (1e-6 + 2e-4 * np.abs(want))
        held = max(held, float(excess[resolved].max(initial=-1.0)))
        diff = np.abs(got - want)[~resolved]
        worst_loose = max(worst_loose, float(diff.max(initial=0.0)))
        loose += int((~resolved).sum())
        total += got.size
    timed = outs[0]["timed"]["chunks"][-1]
    drop_chunks = [o["dropout"]["chunks"] for o in outs]
    drop_losses = [c["loss"] for c in drop_chunks[0]]
    drop_dropped = sum(c["dropped"] for rank in drop_chunks for c in rank)
    drop_unequal = [k for k, v in outs[0]["dropout"]["params"].items()
                    if any(not np.array_equal(o["dropout"]["params"][k], v)
                           for o in outs[1:])]
    log(f"{label} vs the single-device runner, "
        f"{SHARDED_EQ_STEPS} steps (first_k, dropout 0): losses {losses} vs "
        f"{eq['losses']} (worst rel diff {loss_diff:.3e}, limit 1e-5); ids "
        f"equal {np.array_equal(ids, eq['last_ids'])}; dropped {dropped}; "
        f"params after one step beyond rtol 2e-4 / atol 1e-6 where "
        f"resolved: {held:.3e} (limit 0); {loose} of {total} elements "
        f"below {ADAM_FLOOR:g} eps, worst {worst_loose:.3e} (not held)")
    log(f"{label}: 10 steps in "
        f"{timed['seconds'] * 1e3:.2f} ms, {timed['seconds'] * 100:.4f} "
        f"ms/step, {EDGES_PER_STEP * 10 / timed['seconds']:.1f} edges/s "
        f"({card_line})")
    drop_timed = drop_chunks[0][-1]
    log(f"{label} at dropout {DROPOUT} (first_k): losses {drop_losses} "
        f"(the ranks' equal: "
        f"{all([c['loss'] for c in r] == drop_losses for r in drop_chunks)}"
        f"); params not bit-equal across the ranks: "
        f"{drop_unequal or 'none'}; dropped {drop_dropped}; 3 steps in "
        f"{drop_timed['seconds'] * 1e3:.2f} ms, "
        f"{drop_timed['seconds'] / 3 * 1e3:.4f} ms/step ({card_line})")
    check(loss_diff <= 1e-5, f"losses differ by {loss_diff} (relative)")
    check(np.array_equal(ids, eq["last_ids"]), "last ids differ")
    check(dropped == 0, f"{dropped} requests dropped")
    check(held <= 0.0, "params differ beyond rtol 2e-4 / atol 1e-6")
    check(bool(np.all(np.isfinite(drop_losses))),
          f"non-finite losses at dropout {DROPOUT}: {drop_losses}")
    check(all([c["loss"] for c in r] == drop_losses for r in drop_chunks),
          f"the ranks' losses differ at dropout {DROPOUT}")
    check(not drop_unequal, f"the ranks' {drop_unequal} differ at dropout "
          f"{DROPOUT}")
    check(drop_dropped == 0, f"{drop_dropped} requests dropped at dropout "
          f"{DROPOUT}")


# ------------------------------ the sharded unsupervised path (phase 5c)

UNSUP_EQ_STEPS = 5      # steps held to one device (or its reference)


def unsup_eq_config():
    """agg_sweep's "unsup_mean" with the first_k sampler: nothing drawn,
    so two paths sample alike."""
    return first_k(unsup_config(True))


def unsup_reference(dev, data, sets: int) -> dict:
    """The equality runs' inputs and references: ``UNSUP_EQ_STEPS`` steps
    of "unsup_mean" (first_k, dropout 0, weights from seed 0, Adam at
    lr 1e-2 so that a step moves the params past the tolerances) on
    pairs and [steps, ``sets``, 20] negatives from seed 9. "single":
    the single-device runner with each step's first set (every step's
    (loss, MRR), the params and sqrt of Adam's bias-corrected nu after
    the first step, the final params on the card); with ``sets`` above 1
    "per_rank<sets>": the same steps built on one device from ``sets``
    consecutive slices of each batch, slice r with set r (the split and
    negatives of a sharded runner over ``sets`` ranks: the loss the
    slices' summed raw loss over the batch's count, the MRR their summed
    reciprocal ranks over it)."""
    import torch

    from graphsage_tpu_torch.models.graphsage import l2_normalize, sage_embed
    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.nn import prediction
    from graphsage_tpu_torch.parallel.dp import make_unsupervised_chunk_runner

    features, adj, _ = data
    config = unsup_eq_config()
    pairs, negs = unsup_stream(dev, UNSUP_EQ_STEPS, seed=9, sets=sets)
    init = init_unsupervised_params(torch.Generator().manual_seed(0), config)
    out = {"config": config, "pairs": pairs.cpu().numpy(),
           "negs": negs.cpu().numpy(),
           "init": {k: v.numpy() for k, v in init.items()}}

    def fresh():
        params = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in out["init"].items()}
        optimizer = make_optimizer(LEARNING_RATE)
        return params, optimizer, optimizer.init(params)

    def first_state(params, optimizer, opt_state):
        nu = optimizer.state_dict(opt_state, params)["nu"]
        return ({k: v.detach().cpu().numpy() for k, v in params.items()},
                {k: (v.cpu() / (1 - 0.999)).sqrt().numpy()
                 for k, v in nu.items()})

    params, optimizer, opt_state = fresh()
    run = make_unsupervised_chunk_runner(config, optimizer, BATCH)
    shadow = torch.full((), -1.0, device=dev)
    values = []
    for step in range(UNSUP_EQ_STEPS):
        params, opt_state, shadow, loss, mrr = run(
            params, opt_state, shadow, None, features, adj, pairs,
            negs[:, 0], step, 1)
        values.append((float(loss), float(mrr)))
        if step == 0:
            first = first_state(params, optimizer, opt_state)
    out["single"] = {"values": values, "first": first, "final": params}

    for total in (sets,) if sets > 1 else ():
        lb = BATCH // total
        params, optimizer, opt_state = fresh()
        values = []
        for step in range(UNSUP_EQ_STEPS):
            batch = pairs[step * BATCH:(step + 1) * BATCH]
            ids = torch.cat([torch.cat([batch[r * lb:(r + 1) * lb, 0],
                                        batch[r * lb:(r + 1) * lb, 1],
                                        negs[step, r]])
                             for r in range(total)])
            opt_state.zero_grad(set_to_none=True)
            emb = sage_embed(params, features, adj, ids, config.sage,
                             deterministic=False)
            raw = rr = count = 0.0
            for r in range(total):
                o = emb[r * (2 * lb + NEG_SAMPLES):
                        (r + 1) * (2 * lb + NEG_SAMPLES)]
                aff, neg_aff = prediction.edge_pred_scores(
                    l2_normalize(o[:lb], 1), l2_normalize(o[lb:2 * lb], 1),
                    l2_normalize(o[2 * lb:], 1))
                mask = torch.ones(lb, device=dev)
                raw = raw + prediction.pair_loss(aff, neg_aff, "xent", mask)
                ranks, _ = prediction.mrr_and_ranks(aff.detach(),
                                                    neg_aff.detach(), mask)
                rr = rr + (1.0 / ranks.float()).sum()
                count += lb
            loss = raw / count
            loss.backward()
            optimizer.update(opt_state, params)
            values.append((float(loss.detach()), float(rr / count)))
            if step == 0:
                first = first_state(params, optimizer, opt_state)
        out[f"per_rank{total}"] = {"values": values, "first": first}
    return out


def sharded_unsup_one_rank(dev, card_line: str, data, ref: dict,
                           single_ms: list, single_embed: dict) -> dict:
    """"unsup_mean" through the unsupervised sharded stack on a
    world-size-1 NCCL group in this process: the sharded runner against
    the single-device runner (``ref["single"]``: every step's loss and
    MRR equal, every param bit-equal); three timed chunks of 50 steps at
    the cell's settings (shared_perm, dropout 0: K1 once per step,
    nothing dropped, no host synchronisation in a chunk; ms/step beside
    the single-device cell's ``single_ms`` of this call); 4 steps at
    dropout 0.5 (K2 once per step); the sharded embed sweep over every
    node against ``embed_all_nodes`` (first_k: rows bit-equal, K1 once
    per batch; with dedup_gather K3 once per batch, within 1e-5; nodes/s
    and request p50/p90 beside ``single_embed``); and the sharded eval
    sweep against the single-device one (shared_perm, the same sampler
    seed: equal loss and MRR). Returns the launch counts."""
    import dataclasses

    import torch

    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.models.unsupervised import (
        init_unsupervised_params,
    )
    from graphsage_tpu_torch.parallel.graph_sharded import (
        make_sharded_unsup_embed,
        make_sharded_unsup_eval_sweep,
        make_sharded_unsupervised_chunk_runner,
    )
    from graphsage_tpu_torch.train.unsupervised import (
        embed_all_nodes,
        make_unsup_eval_sweep,
        sharded_embed_all_nodes,
    )

    features, adj, _ = data
    out = {}
    with one_rank_group(dev) as grid:
        # 1. the runner against the single-device runner
        config = ref["config"]
        params = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in ref["init"].items()}
        optimizer = make_optimizer(LEARNING_RATE)
        opt_state = optimizer.init(params)
        run = make_sharded_unsupervised_chunk_runner(config, optimizer, grid,
                                                     BATCH)
        pairs = torch.from_numpy(ref["pairs"]).to(dev)
        negs = torch.from_numpy(ref["negs"][:, :1].copy()).to(dev)
        shadow = torch.full((), -1.0, device=dev)
        values, dropped = [], 0
        for step in range(UNSUP_EQ_STEPS):
            params, opt_state, shadow, loss, mrr, d = run(
                params, opt_state, shadow, None, features, adj, pairs, negs,
                step, 1)
            values.append((float(loss), float(mrr)))
            dropped += int(d)
        want = ref["single"]
        unequal = [k for k in params
                   if not torch.equal(params[k], want["final"][k])]
        log(f"unsupervised sharded D=1 vs the single-device runner, "
            f"{UNSUP_EQ_STEPS} steps (first_k, dropout 0, lr "
            f"{LEARNING_RATE}): (loss, MRR) {values} vs {want['values']}; "
            f"params not bit-equal: {unequal or 'none'}; dropped {dropped}")
        check(values == want["values"], "unsupervised sharded D=1 and "
              "single-device losses or MRRs differ")
        check(not unequal, f"unsupervised sharded D=1 params differ from "
              f"the single-device runner's in {unequal}")
        check(dropped == 0, "requests dropped at D=1")
        del params, opt_state, want["final"]

        # 2. the cell's training: K1 once per step, then K2 at dropout
        timed_pairs, timed_negs = unsup_stream(dev, 5 + 3 * TRAIN_CHUNK + 14,
                                               seed=5, sets=1)
        for dropout in (0.0, DROPOUT):
            cfg = unsup_config(True)
            cfg = dataclasses.replace(cfg, sage=dataclasses.replace(
                cfg.sage, dropout=dropout))
            params = init_unsupervised_params(
                torch.Generator().manual_seed(0), cfg, device=dev)
            optimizer = make_optimizer(UNSUP_LR)
            opt_state = optimizer.init(params)
            run = make_sharded_unsupervised_chunk_runner(cfg, optimizer, grid,
                                                         BATCH)
            gen = torch.Generator(device=dev).manual_seed(13)
            state = {"step": 0, "shadow": torch.full((), -1.0, device=dev)}

            def chunk(n):
                nonlocal params, opt_state
                (params, opt_state, state["shadow"], loss, mrr,
                 d) = run(params, opt_state, state["shadow"], gen, features,
                          adj, timed_pairs, timed_negs, state["step"], n,
                          drop_seed=7)
                state["step"] += n
                return loss, mrr, d

            if dropout > 0.0:
                reset_counts()
                loss, _, d = chunk(4)
                counts = launch_counts()
                check_counts(counts, "K2", 4, f"unsupervised sharded D=1 at "
                             f"dropout {DROPOUT}")
                check(np.isfinite(float(loss)) and int(d) == 0,
                      f"dropout {DROPOUT}: loss {float(loss)}, dropped "
                      f"{int(d)}")
                log(f"unsupervised sharded D=1 at dropout {DROPOUT}: 4 "
                    f"steps, launches {counts}, loss {float(loss):.5f}")
                out["K2"] = counts["K2"]
                continue
            chunk(5)                             # warm-up
            reset_counts()
            times, reads, dropped = [], [], 0
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, mrr, d = chunk(TRAIN_CHUNK)
                reads.append(torch.stack([loss, mrr, state["shadow"]])
                             .tolist())        # the print boundary
                times.append(time.perf_counter() - t0)
                dropped += int(d)
                lv, mv, sv = reads[-1]
                check(np.isfinite(lv) and 0.0 < mv <= 1.0 and 0.0 < sv <= 1.0,
                      f"unsupervised sharded D=1: loss {lv}, MRR {mv}, EMA "
                      f"{sv}")
            counts = launch_counts()
            check_counts(counts, "K1", 3 * TRAIN_CHUNK,
                         "unsupervised sharded D=1 training")
            check(dropped == 0, f"{dropped} requests dropped")
            for i, (dt, (lv, mv, sv)) in enumerate(zip(times, reads)):
                ms = dt / TRAIN_CHUNK * 1e3
                log(f"unsupervised sharded D=1 mean train chunk {i + 1}: "
                    f"{TRAIN_CHUNK} steps in {dt * 1e3:.2f} ms, {ms:.4f} "
                    f"ms/step ({ms / single_ms[i]:.2f}x the single-device "
                    f"cell's {single_ms[i]:.4f} in this call), "
                    f"{UNSUP_EDGES_PER_STEP * TRAIN_CHUNK / dt:.1f} edges/s; "
                    f"loss {lv:.5f}, train MRR {mv:.5f}, EMA {sv:.5f} "
                    f"({card_line})")
            log(f"unsupervised sharded D=1 training: launches {counts} in "
                f"{3 * TRAIN_CHUNK} steps; dropped requests {dropped}")
            out["K1_train"] = counts["K1"]
            syncs = count_syncs("unsupervised sharded D=1 mean",
                                lambda: chunk(10), 10)
            check(syncs == 0, f"unsupervised sharded D=1: {syncs} host "
                  f"synchronisations per step")
            profile_window(lambda: chunk(4),
                           "unsupervised sharded D=1, 4 training steps")
            del params, opt_state

        # 3. the embed sweep against embed_all_nodes
        params = init_unsupervised_params(torch.Generator().manual_seed(0),
                                          config, device=dev)
        want = embed_all_nodes(config, BATCH, params, features, adj, seed=1)
        n_b = -(-NUM_NODES // BATCH)
        sharded_embed_all_nodes(config, grid, BATCH, params, features, adj,
                                1, 4.0)                     # warm-up
        for label, cfg, kernel in (
                ("mean", config, "K1"),
                ("mean dedup_gather", dataclasses.replace(
                    config, sage=dataclasses.replace(
                        config.sage, dedup_gather=True)), "K3")):
            rates = []
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows, dropped = sharded_embed_all_nodes(
                cfg, grid, BATCH, params, features, adj, 1, 4.0)
            dt = time.perf_counter() - t0
            counts = launch_counts()
            check_counts(counts, kernel, n_b,
                         f"unsupervised sharded D=1 {label} embed sweep")
            diff = float(np.abs(rows - want).max())
            log(f"unsupervised sharded D=1 {label} embed sweep: {NUM_NODES} "
                f"nodes in {n_b} batches, rows on the host: {dt * 1e3:.2f} "
                f"ms, {NUM_NODES / dt:.1f} nodes/s ({card_line}); launches "
                f"{counts}; dropped {int(dropped)}; rows max abs diff "
                f"{diff:.3e} vs embed_all_nodes (K1)")
            check(int(dropped) == 0, "requests dropped in the embed sweep")
            if kernel == "K1":
                check(np.array_equal(rows, want), "the sharded D=1 embed "
                      "sweep's rows are not embed_all_nodes' rows")
            else:
                check(diff <= 1e-5, f"the K3 embed sweep differs by {diff}")
            out[f"{kernel}_embed"] = counts[kernel]
        cell = unsup_config(True)       # the cell's sampler, shared_perm
        for _ in range(2):
            t0 = time.perf_counter()
            sharded_embed_all_nodes(cell, grid, BATCH, params, features, adj,
                                    1, 4.0)
            rates.append(NUM_NODES / (time.perf_counter() - t0))
        embed_fn = make_sharded_unsup_embed(cell, grid)
        ids = torch.arange(n_b * BATCH, dtype=torch.int32, device=dev)
        ids[NUM_NODES:] = NUM_NODES
        lat = []
        for i in range(n_b):
            t1 = time.perf_counter()
            embed_fn(params, features, adj,
                     ids[i * BATCH:(i + 1) * BATCH])[0].cpu()
            lat.append((time.perf_counter() - t1) * 1e3)
        p50, p90 = np.percentile(lat, 50), np.percentile(lat, 90)
        single_rates = single_embed["nodes_per_s"]
        log(f"unsupervised sharded D=1 embed sweep: "
            f"{', '.join(f'{r:.1f}' for r in rates)} nodes/s against the "
            f"single-device sweep's "
            f"{', '.join(f'{r:.1f}' for r in single_rates)} in this call "
            f"({min(single_rates) / max(rates):.2f}-"
            f"{max(single_rates) / min(rates):.2f}x the time); per request "
            f"of {BATCH} nodes p50 {p50:.3f} ms, p90 "
            f"{p90:.3f} ms (single-device p50 {single_embed['p50']:.3f}, p90 "
            f"{single_embed['p90']:.3f}) ({card_line})")

        # 4. the eval sweep against the single-device sweep
        cfg = unsup_config(True)
        val_pairs, val_negs = unsup_stream(dev, 20, seed=11, sets=1)
        single = make_unsup_eval_sweep(cfg, BATCH)(
            params, features, adj, val_pairs, val_negs[0, 0],
            torch.Generator(device=dev).manual_seed(2))
        t0 = time.perf_counter()
        loss, mrr, dropped = make_sharded_unsup_eval_sweep(cfg, grid, BATCH)(
            params, features, adj, val_pairs, val_negs[0],
            torch.Generator(device=dev).manual_seed(2))
        dt = time.perf_counter() - t0
        log(f"unsupervised sharded D=1 eval sweep, 20 batches (shared_perm): "
            f"loss {float(loss):.6f}, MRR {float(mrr):.6f} vs single-device "
            f"{float(single[0]):.6f}, {float(single[1]):.6f}; {dt * 1e3:.2f} "
            f"ms; dropped {int(dropped)}")
        check(float(loss) == float(single[0]) and float(mrr) == float(
            single[1]), "the sharded D=1 eval sweep differs from the "
              "single-device sweep")
        check(int(dropped) == 0, "requests dropped in the eval sweep")
    return out


def sharded_unsup_ranks(card_line: str, data, ref: dict, devices: list,
                        backend: str, grids: tuple) -> None:
    """Ranks on ``devices`` over ``backend`` (``parallel/launch.py``), one
    spawn for every grid of ``grids`` (each with as many ranks as
    devices): ``UNSUP_EQ_STEPS`` steps of the unsupervised runner at
    first_k, dropout 0, lr 1e-2 and an exact capacity. A data-parallel
    grid (1 x M) draws one negative set a step and is held to the
    single-device runner (``ref["single"]``); a graph-sharded one to the
    one-device reference built from its ranks' negatives
    (``ref["per_rank<total>"]``): each step's loss within 1e-5
    (relative), its MRR within 1e-5 or one near-tie off
    (``mrr_flips``), at most one such step in the run, the ranks' params
    bit-equal, nothing dropped, and the params after the first step
    within rtol 2e-4 / atol 1e-6 where Adam's sqrt(v) is 1e3 eps or
    more (the elements below are counted). Every grid is logged before
    any is checked. On one card: gloo, the collectives staged through
    the host, so no time target."""
    import shutil

    import torch

    from graphsage_tpu_torch.parallel import launch

    features, adj, _ = data
    jobs = {}
    for grid in grids:
        total = grid[0] * grid[1]
        dp = grid[0] == 1
        jobs[grid] = dict(
            kind="unsup_train", grid=grid, runner="dp" if dp else "sharded",
            unsup_config=ref["config"], params=ref["init"],
            features=features.cpu().numpy(), adj=adj.cpu().numpy(),
            pairs_perm=ref["pairs"],
            neg_ids=(ref["negs"][:, 0].copy() if dp
                     else ref["negs"][:, :total].copy()),
            batch_size=BATCH, lr=LEARNING_RATE,
            capacity_factor=float(grid[0]),      # exact: nothing drops
            chunks=[(s, 1) for s in range(UNSUP_EQ_STEPS)], first=True)
    scratch = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    label = f"{len(devices)} ranks ({backend})"
    try:
        torch.save(jobs, os.path.join(scratch, "jobs.pt"))
        del jobs
        t0 = time.perf_counter()
        launch.spawn(launch.check_rank,
                     (os.path.join(scratch, "jobs.pt"), scratch), devices,
                     f"file://{scratch}/store", backend=backend,
                     timeout_s=600)
        log(f"unsupervised sharded on {label}, grids {grids}: "
            f"{time.perf_counter() - t0:.2f} s, start-up included")
        outs = [torch.load(os.path.join(scratch, f"rank{r}.pt"),
                           weights_only=False) for r in range(len(devices))]
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    checks = []
    for grid in grids:
        total = grid[0] * grid[1]
        want = ref["single" if grid[0] == 1 else f"per_rank{total}"]
        name = (f"unsupervised sharded {grid[0]} x {grid[1]} on {label}"
                + (" (data-parallel)" if grid[0] == 1 else ""))
        chunks = [o[grid]["chunks"] for o in outs]
        got = [(c["loss"], c["mrr"]) for c in chunks[0]]
        loss_diff = max(abs(a[0] - b[0]) / abs(b[0])
                        for a, b in zip(got, want["values"]))
        mrr_diff = max(abs(a[1] - b[1]) for a, b in zip(got, want["values"]))
        flips = [mrr_flips(a[1], b[1]) for a, b in zip(got, want["values"])]
        dropped = sum(c["dropped"] for rank in chunks for c in rank)
        held = loose = n_el = 0
        worst_loose = 0.0
        first_params, root_nu = want["first"]
        for k, v in first_params.items():
            ours = outs[0][grid]["first"][k]
            for o in outs[1:]:
                for part in ("first", "params"):
                    check(np.array_equal(o[grid][part][k],
                                         outs[0][grid][part][k]),
                          f"{name}: the ranks' {k} differ")
            resolved = root_nu[k] >= ADAM_FLOOR * 1e-8
            excess = np.abs(ours - v) - (1e-6 + 2e-4 * np.abs(v))
            held = max(held, float(excess[resolved].max(initial=-1.0)))
            worst_loose = max(worst_loose, float(
                np.abs(ours - v)[~resolved].max(initial=0.0)))
            loose += int((~resolved).sum())
            n_el += v.size
        ms = [c["seconds"] * 1e3 for c in chunks[0][1:]]
        against = ("the single-device runner" if grid[0] == 1 else
                   "the one-device reference from its ranks' negatives")
        log(f"{name} vs {against}, "
            f"{UNSUP_EQ_STEPS} steps (first_k, dropout 0): (loss, MRR) {got}"
            f" vs {want['values']} (worst rel loss diff {loss_diff:.3e}, "
            f"limit 1e-5; MRR diff {mrr_diff:.3e}, near-tie rank flips by "
            f"step {flips}, limit one step of one flip); dropped {dropped}; "
            f"params after one step beyond rtol 2e-4 / atol 1e-6 where "
            f"resolved: {held:.3e} (limit 0); {loose} of {n_el} elements "
            f"below {ADAM_FLOOR:g} eps, worst {worst_loose:.3e} (not held); "
            f"steps 2-{UNSUP_EQ_STEPS} "
            f"{', '.join(f'{m:.2f}' for m in ms)} ms ({card_line})")
        checks += [
            (loss_diff <= 1e-5, f"{name}: losses differ by {loss_diff}"),
            (None not in flips and sum(flips) <= 1,
             f"{name}: MRRs differ by more than one near-tie: {flips}"),
            (dropped == 0, f"{name}: {dropped} requests dropped"),
            (held <= 0.0, f"{name}: params differ beyond rtol 2e-4 / atol "
             f"1e-6")]
    for ok, msg in checks:
        check(ok, msg)


def mrr_flips(got: float, want: float, batch: int = BATCH):
    """0 if two MRRs of ``batch`` pairs agree within 1e-5; 1 if they are
    one pair's rank one place apart: the two sides rank every pair alike
    but one, whose positive score is within rounding of a negative's,
    so that pair's reciprocal rank moves from 1/r to 1/(r+1) and the
    MRR by (1/r - 1/(r+1)) / batch (to 1e-4 / batch: the f32 sums'
    rounding); None otherwise. The embeddings on the two sides round
    apart by ~1e-7, and a batch of 512 pairs scored against 20
    negatives holds ~10k positive-negative margins, so a margin that
    small turns up in a few percent of steps."""
    gap = abs(got - want) * batch
    if gap <= 1e-5 * batch:
        return 0
    if any(abs(gap - (1 / r - 1 / (r + 1))) <= 1e-4
           for r in range(1, NEG_SAMPLES + 1)):
        return 1
    return None


def sharded_cli_refusal(dev) -> None:
    """``python -m graphsage_tpu_torch supervised --graph_shards 2`` and
    ``unsupervised --graph_shards 2`` on this one-card machine, started
    together: each must fail, naming the two devices it needs, and must
    write no logs (nor train on the CPU)."""
    from graphsage_tpu_torch.data.synthetic import (
        make_synthetic_graph,
        write_dataset,
    )

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        prefix = os.path.join(tmp, "toy", "toy")
        write_dataset(make_synthetic_graph(num_nodes=60, num_classes=3,
                                           feat_dim=8, seed=3), prefix)
        procs = {}
        try:
            for command in ("supervised", "unsupervised"):
                pairs = (["--no-random_context"] if command == "unsupervised"
                         else [])
                procs[command] = subprocess.Popen(
                    [sys.executable, "-m", "graphsage_tpu_torch", command,
                     "--train_prefix", prefix, "--graph_shards", "2",
                     "--base_log_dir", os.path.join(tmp, f"log_{command}"),
                     "--device", str(dev.type)] + pairs, cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for command, proc in procs.items():
                _, stderr = proc.communicate(timeout=300)
                last = (stderr.strip().splitlines() or [""])[-1]
                log(f"{command} --graph_shards 2 on one card: exit "
                    f"{proc.returncode}, {last}")
                check(proc.returncode != 0,
                      f"{command} --graph_shards 2 ran on one card")
                check("needs 2 CUDA devices" in stderr,
                      f"{command}: the refusal does not name the two devices")
                check(not os.path.exists(os.path.join(tmp,
                                                      f"log_{command}")),
                      f"the refused {command} run wrote logs")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def cli_phases(dev) -> None:
    """Every CLI check: ``predict`` (plain and ``--dedup_gather``),
    ``supervised`` (graphsage_mean, graphsage_meanpool, graphsage_seq
    with ``--rows_gather``, and graphsage_mean with ``--degree_relabel
    --defer_features --log_histograms --profile_dir``), and ``walks``,
    then ``unsupervised`` and ``embed`` (graphsage_mean,
    graphsage_meanpool) and ``unsupervised --model n2v`` followed by
    ``eval``. The card-side
    processes start together, since each takes seconds to reach the
    card; the CPU references run here meanwhile, one after another.
    Every process is ended before this returns."""
    scratch = os.path.join(ROOT, "build")   # listed in .gitignore
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        prefix = walks_dataset(os.path.join(tmp, "walks"))
        jobs = [
            predict_job(dev, os.path.join(tmp, "p0"), {}),
            predict_job(dev, os.path.join(tmp, "p1"), {"dedup_gather": True}),
            supervised_job(dev, os.path.join(tmp, "s0"), "graphsage_mean",
                           {}),
            supervised_job(dev, os.path.join(tmp, "s1"),
                           "graphsage_meanpool", {}),
            supervised_job(dev, os.path.join(tmp, "s2"), "graphsage_seq",
                           {"rows_gather": True}),
            unsupervised_job(dev, os.path.join(tmp, "u0"), prefix,
                             "graphsage_mean"),
            unsupervised_job(dev, os.path.join(tmp, "u1"), prefix,
                             "graphsage_meanpool"),
            n2v_job(dev, os.path.join(tmp, "n2v"), prefix),
            supervised_job(dev, os.path.join(tmp, "s3"), "graphsage_mean",
                           {"degree_relabel": True, "defer_features": True,
                            "log_histograms": True}, profile=True),
        ]
        t0 = time.perf_counter()
        procs = []
        try:
            for _, cmd, _ in jobs:
                procs.append(subprocess.Popen(
                    cmd, cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            for proc, (label, _, finish) in zip(procs, jobs):
                stdout, stderr = proc.communicate(timeout=600)
                log(f"[{label}: card process done at "
                    f"{time.perf_counter() - t0:.2f} s]")
                finish(proc.returncode, stdout, stderr)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from graphsage_tpu_torch.ops import build

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    card_line = card()
    log(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"[phase {name}: {time.perf_counter() - t0:.2f} s]")
        return result

    def build_kernels(names=("gather_mean", "gather_rows",
                             "gather_mlp_pool", "gather_probe")):
        """One nvcc per source, all started together."""
        def timed(name):
            t0 = time.perf_counter()
            _, nvcc_log = build.build(name)
            return name, time.perf_counter() - t0, nvcc_log

        with concurrent.futures.ThreadPoolExecutor() as pool:
            results = list(pool.map(timed, names))
        for name, seconds, nvcc_log in results:
            log(f"built {name}.cu in {seconds:.2f} s")
            for line in nvcc_log.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line):
                    log(f"  ptxas: {line.split(':', 1)[-1].strip()}")

    if sys.argv[1:2] == ["--cards"]:
        n = int(sys.argv[2])
        check(torch.cuda.device_count() >= n,
              f"--cards {n}: {torch.cuda.device_count()} cards here")
        phase("build K1+K2+K3 (gather_mean.cu)", build_kernels,
              ("gather_mean",))
        data = phase("bench data", bench_data, dev)
        eq = phase("the single-device runner", single_device_reference,
                   dev, data)
        devices = [torch.device("cuda", r) for r in range(n)]
        for grid in ((n, 1), (n // 2, 2)):
            phase(f"sharded {grid[0]} x {grid[1]} on {n} cards (nccl)",
                  sharded_ranks, card_line, data, eq, devices, "nccl", grid)
        del eq
        ref = phase("the unsupervised references", unsup_reference, dev,
                    data, n)
        phase(f"unsupervised sharded {n} x 1 and {n // 2} x 2 on {n} cards "
              f"(nccl)", sharded_unsup_ranks, card_line, data, ref, devices,
              "nccl", ((n, 1), (n // 2, 2)))
        return 0
    if sys.argv[1:] == ["--loads"]:
        phase("build K1+K2+K3 (gather_mean.cu)", build_kernels,
              ("gather_mean",))
        data = phase("bench data", bench_data, dev)
        phase("K1/K3 load probe", probe_loads, dev, card_line, data)
        return 0
    phase("build K1+K2+K3 (gather_mean.cu), K4 (gather_rows.cu), K5+K6 "
          "(gather_mlp_pool.cu), K7 (gather_probe.cu)", build_kernels)
    sass_summary()
    data = phase("bench data", bench_data, dev)
    k1 = phase("K1 vs plain", check_gather_mean, dev, card_line, data)
    k2 = phase("K2 vs plain", check_gather_mean_dropout, dev, card_line)
    k3 = phase("K3 vs plain", check_gather_mean_dedup, dev, card_line, data)
    unsup_hop = phase("K1 and K3 at the unsupervised hop", check_unsup_hop,
                      dev, card_line, data)
    k4 = phase("K4 vs plain", check_gather_rows, dev, card_line, data)
    k5 = phase("K5 vs plain", check_pool, dev, card_line)
    k6 = phase("K6 vs plain", check_pool_train, dev, card_line)
    k7 = phase("K7 vs plain", check_probe, dev, card_line)

    k1["launches"], mean_preds = phase(
        "mean serving", serve_full_width, dev, data, "mean",
        bench_config(True), "K1", bench_config(False))
    k3["launches"], _ = phase(
        "mean serving, dedup_gather", serve_full_width, dev, data,
        "mean dedup_gather", bench_config(True, dedup=True), "K3", None,
        mean_preds)
    del mean_preds
    k5["launches"], _ = phase(
        "meanpool serving", serve_full_width, dev, data, "meanpool",
        bench_config(True, aggregator="meanpool"), "K5",
        bench_config(False, aggregator="meanpool"))
    k4["launches"], _ = phase(
        "seq serving, rows_gather", serve_full_width, dev, data,
        "seq rows_gather", bench_config(True, aggregator="seq", rows=True),
        "K4", bench_config(True, aggregator="seq"), None, 1, 64)
    phase("maxpool serving, rows_gather", serve_rows_batches, dev, data,
          "maxpool")
    k2["launches"] = phase(
        "mean training", train_full_width, dev, data, "mean",
        bench_config(True, DROPOUT), "K2")
    k6["launches"] = phase(
        "meanpool training", train_full_width, dev, data, "meanpool",
        bench_config(True, DROPOUT, "meanpool"), "K6")
    phase("seq training, rows_gather", train_full_width, dev, data,
          "seq rows_gather", bench_config(True, 0.0, "seq", rows=True), "K4",
          2, SEQ_TRAIN_CHUNK, 4, 3)
    k1["launches_unsup_train"], unsup_ms = phase(
        "unsupervised mean training (unsup_mean)", train_unsupervised, dev,
        data)
    k1["launches_embed_sweep"], embed_stats = phase(
        "embed sweep", embed_full_width, dev, data)
    routes = phase("unsupervised routes through K2, K6 and K5",
                   unsup_other_routes, dev, data)
    k2["launches_unsup_train"] = routes["K2"]
    k6["launches_unsup_train"] = routes["K6"]
    k5["launches_embed_sweep"] = routes["K5"]
    sharded = phase("sharded D=1 (nccl)", sharded_one_rank, dev, card_line,
                    data)
    k2["launches_sharded_train"] = sharded["K2"]
    k1["launches_sharded_sweep"] = sharded["K1"]
    k3["launches_sharded_sweep"] = sharded["K3"]
    phase("sharded D=2 on one card (gloo)", sharded_ranks, card_line, data,
          sharded["eq"], [dev, dev], "gloo", (2, 1))
    del sharded
    ref = phase("the unsupervised references", unsup_reference, dev, data, 2)
    unsup_sharded = phase("unsupervised sharded D=1 (nccl)",
                          sharded_unsup_one_rank, dev, card_line, data, ref,
                          unsup_ms, embed_stats)
    k1["launches_unsup_sharded_train"] = unsup_sharded["K1_train"]
    k1["launches_unsup_sharded_embed"] = unsup_sharded["K1_embed"]
    k2["launches_unsup_sharded_train"] = unsup_sharded["K2"]
    k3["launches_unsup_sharded_embed"] = unsup_sharded["K3_embed"]
    phase("unsupervised sharded 1 x 2 and 2 x 1 on one card (gloo)",
          sharded_unsup_ranks, card_line, data, ref, [dev, dev], "gloo",
          ((1, 2), (2, 1)))
    del ref, unsup_sharded
    phase("CLI: supervised and unsupervised --graph_shards 2 on one card",
          sharded_cli_refusal, dev)
    graph = phase("native host builder on bench.py's graph", native_walks,
                  data)
    target = phase("node2vec at full width", train_node2vec, dev, graph)
    phase("eval at full width", eval_full_width, dev, target,
          graph["is_train"])
    del graph, target
    k1["ms_unsup_hop"] = unsup_hop["ms"]
    k1["bound_ms_unsup_hop"] = unsup_hop["bound_ms"]
    for label, fused, plain, kernel, p_limit in (
            ("mean", bench_config(True), bench_config(False), "K1", 1e-4),
            ("meanpool", bench_config(True, aggregator="meanpool"),
             bench_config(False, aggregator="meanpool"), "K6", None),
            ("seq", bench_config(True, aggregator="seq", rows=True),
             bench_config(True, aggregator="seq"), "K4", 1e-6),
            ("mean dedup_gather", bench_config(True, dedup=True),
             bench_config(False), "K3", 1e-4)):
        phase(f"{label} training with vs without {kernel}",
              fused_vs_unfused_training, dev, data, label, fused, plain,
              kernel, p_limit)
    for aggregator, kernel, p_limit in (("mean", "K1", 1e-4),
                                        ("meanpool", "K6", None)):
        phase(f"unsupervised {aggregator} training with vs without {kernel}",
              fused_vs_unfused_unsup, dev, data,
              f"unsupervised {aggregator}", kernel, aggregator, p_limit)
    phase("CLI: predict (and --dedup_gather), supervised (mean, meanpool, "
          "seq --rows_gather, mean with the data and logging options), "
          "walks, unsupervised and embed (mean, meanpool), node2vec and "
          "eval on the card against the CPU", cli_phases, dev)
    probe_counts = phase("the probe's entry point (K7)", drive_probe, dev,
                         card_line)
    for (key, _, _), entry in zip(K7_INSTANCES, k7):
        entry["launches"] = probe_counts[key]
    log(f"chip_smoke total {time.perf_counter() - t_start:.2f} s")

    log(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, *k7]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
