"""Seed study of the port's supervised proxy-ppi rows.

The escape-dominated proxy-ppi rows (weak features, dense multilabel
sigmoid loss) carry +-0.03-0.05 of init and shuffle noise
(``benchmarks/REFERENCE_PARITY.md``, "Seed-variance study"), so one
seed cannot decide a row that lands outside its band. This runs the
JAX package's ``benchmarks/seed_study.py`` protocol through the port:
proxy-ppi at full spec (generator seed 11), batch 512, fanouts 25/10,
dims 128/128, max degree 128, Adam at lr 0.01, sigmoid loss, 40
epochs, one run for each model and training seed.

    python -m graphsage_tpu_torch.benchmarks.seed_study \\
        [--models graphsage_meanpool,graphsage_seq] [--seeds 123-127]

Appends one JSON line a run to ``SEED_STUDY_H100.jsonl`` beside this
file (the JAX script's keys, plus ``device``), then prints each model's
mean over the seeds against the JAX package's value: its own five-seed
mean where ``benchmarks/SEED_STUDY.jsonl`` has one, else its one-seed
value, within the row's band (``accuracy_acceptance.band``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from graphsage_tpu_torch.benchmarks.accuracy_acceptance import (
    DEFAULT_ROOT,
    JAX_MICRO_F1,
    JAX_SEED_MEAN,
    band,
    build_kernels,
    card_line,
    gen_datasets,
)

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, "SEED_STUDY_H100.jsonl")
DATASET = "proxy-ppi"


def parse_seeds(text: str) -> list:
    """An inclusive range ``a-b`` or a comma list."""
    if "-" in text:
        a, b = text.split("-")
        seeds = list(range(int(a), int(b) + 1))
    else:
        seeds = [int(s) for s in text.split(",") if s]
    if not seeds:
        raise ValueError(f"no seeds in {text!r}")
    return seeds


def study_flags(prefix: str, root: str, model: str, seed: int, **kw):
    """The study's TrainFlags for one run, updated by ``kw``."""
    from graphsage_tpu_torch.train.config import TrainFlags

    base = dict(
        train_prefix=prefix,
        base_log_dir=os.path.join(root, "logs", f"seedstudy-{model}-{seed}"),
        model=model, sigmoid=True, epochs=40,
        batch_size=512, samples_1=25, samples_2=10,
        dim_1=128, dim_2=128, max_degree=128,
        validate_iter=5000, validate_batch_size=256,
        print_every=200, learning_rate=0.01, seed=seed,
    )
    base.update(kw)
    return TrainFlags(**base)


def run_one(flags, device, device_name: str) -> dict:
    """Train one run; its JSON line."""
    from graphsage_tpu_torch.train.supervised import train as train_sup

    t0 = time.perf_counter()
    res = train_sup(flags, device=device)
    return {
        "dataset": DATASET, "model": flags.model, "seed": flags.seed,
        "test_f1_mic": round(float(res["test_f1_mic"]), 4),
        "test_f1_mac": round(float(res["test_f1_mac"]), 4),
        "wall_s": round(time.perf_counter() - t0, 1),
        "epochs": flags.epochs,
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "device": device_name,
    }


def decide(model: str, micro_f1s: list) -> dict:
    """A model's mean over seeds against the JAX package's value."""
    key = (DATASET, f"supervised {model}")
    mean = sum(micro_f1s) / len(micro_f1s)
    jax_value = JAX_SEED_MEAN.get(key, JAX_MICRO_F1[key])
    half = band(*key)
    return {"model": model, "seeds": len(micro_f1s), "mean": round(mean, 4),
            "jax": jax_value, "band": half,
            "inside": abs(round(mean, 4) - jax_value) <= half + 1e-9}


def main(argv=None) -> int:
    from graphsage_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="graphsage_meanpool,graphsage_seq")
    ap.add_argument("--seeds", default="123-127",
                    help="inclusive range a-b or comma list")
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--out", default=OUT_PATH)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    seeds = parse_seeds(args.seeds)
    device = resolve_device(args.device)
    device_name = "cpu"
    if device.type == "cuda":
        device_name = card_line()
        build_kernels()

    prefix, _ = gen_datasets(args.root, quick=False, names=(DATASET,))[DATASET]
    for model in args.models.split(","):
        mics = []
        for seed in seeds:
            row = run_one(study_flags(prefix, args.root, model, seed),
                          device, device_name)
            mics.append(row["test_f1_mic"])
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as fp:
                fp.write(json.dumps(row) + "\n")
        print(json.dumps(decide(model, mics)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
