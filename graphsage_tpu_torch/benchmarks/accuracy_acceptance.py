"""Accuracy acceptance of the port on the power-law proxy datasets.

The JAX package's ``benchmarks/accuracy_acceptance.py``, run through the
port's own entry points: supervised training (``train/supervised``),
unsupervised GraphSAGE and node2vec (``train/unsupervised``) and the
logistic probe (``evaluation.evaluate_embeddings``), on two
degree-skewed proxies generated from a seed (``make_powerlaw_graph``):

  proxy-ppi:    15k nodes, 121 multilabel classes, 50 features, mean
                degree 29, generator seed 11
  proxy-reddit: 50k nodes, 41 classes, 602 features, mean degree 60,
                generator seed 12

The same spec and seed write the same files as the JAX package's
script, walks included. The rows, their flags and their order are that
script's. Each row stands beside the JAX package's micro-F1 from
``benchmarks/RESULTS.md:25-42`` and a band around it drawn from the
spread the JAX side shows against the TF1 reference and across seeds
(``benchmarks/REFERENCE_PARITY.md``); a row outside its band is decided
by ``seed_study.py``.

    python -m graphsage_tpu_torch.benchmarks.accuracy_acceptance
    python -m graphsage_tpu_torch.benchmarks.accuracy_acceptance \\
        --datasets proxy-reddit --runs "n2v + logreg"
    python -m graphsage_tpu_torch.benchmarks.accuracy_acceptance \\
        --quick --device cpu --out /tmp/table.md

The table (``RESULTS_H100.md`` beside this file by default) is written
again after every row, so a run cut short loses nothing. A run of a
subset (``--datasets`` or ``--runs``) merges its rows into the table
already there, which must be of the same mode and device; a run of
every row writes a new one.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(HERE, "RESULTS_H100.md")
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "graphsage_proxy_data")

DATASETS = ("proxy-ppi", "proxy-reddit")
SUPERVISED_MODELS = ("graphsage_mean", "gcn", "graphsage_maxpool",
                     "graphsage_meanpool", "graphsage_seq")
UNSUP_RUN = "unsupervised mean + logreg"
FEAT_RUN = "raw features + logreg (baseline)"
DUMMY_RUN = "random dummy + logreg (baseline)"
N2V_RUN = "n2v + logreg"
RUNS = tuple(f"supervised {m}" for m in SUPERVISED_MODELS) + (
    UNSUP_RUN, FEAT_RUN, DUMMY_RUN, N2V_RUN)

# The JAX package's micro-F1 on the same data, from benchmarks/RESULTS.md
# lines 25-42 (full mode).
JAX_MICRO_F1 = {
    ("proxy-ppi", "supervised graphsage_mean"): 0.5250,
    ("proxy-ppi", "supervised gcn"): 0.5274,
    ("proxy-ppi", "supervised graphsage_maxpool"): 0.6461,
    ("proxy-ppi", "supervised graphsage_meanpool"): 0.6222,
    ("proxy-ppi", "supervised graphsage_seq"): 0.5771,
    ("proxy-ppi", UNSUP_RUN): 0.2342,
    ("proxy-ppi", FEAT_RUN): 0.2005,
    ("proxy-ppi", DUMMY_RUN): 0.0000,
    ("proxy-ppi", N2V_RUN): 0.3758,
    ("proxy-reddit", "supervised graphsage_mean"): 0.9833,
    ("proxy-reddit", "supervised gcn"): 0.9849,
    ("proxy-reddit", "supervised graphsage_maxpool"): 0.9607,
    ("proxy-reddit", "supervised graphsage_meanpool"): 0.9692,
    ("proxy-reddit", "supervised graphsage_seq"): 0.9197,
    ("proxy-reddit", UNSUP_RUN): 0.5596,
    ("proxy-reddit", FEAT_RUN): 0.2025,
    ("proxy-reddit", DUMMY_RUN): 0.0265,
    ("proxy-reddit", N2V_RUN): 0.9956,
}
# The JAX package's five-seed means (seeds 123-127), from
# benchmarks/SEED_STUDY.jsonl: a supervised row outside its band is held
# to these, where they exist, instead of the one-seed value.
JAX_SEED_MEAN = {
    ("proxy-ppi", "supervised graphsage_meanpool"): 0.6250,
    ("proxy-ppi", "supervised graphsage_seq"): 0.5967,
}


def band(dataset: str, run: str) -> float:
    """Half-width of the row's band around the JAX micro-F1:
    - proxy-reddit supervised 0.02: JAX and the TF1 reference are at
      most 0.0136 apart there (seq);
    - proxy-ppi supervised 0.05: the five-seed range of the
      escape-dominated rows, 0.03-0.05;
    - the unsupervised and n2v probes 0.03: JAX and the reference are
      0.013-0.018 apart;
    - raw features 0.02: the data is byte-equal, only the probe's
      shuffle differs;
    - the dummy 0.01: it predicts the train prior."""
    if run.startswith("supervised "):
        return 0.05 if dataset == "proxy-ppi" else 0.02
    return {UNSUP_RUN: 0.03, N2V_RUN: 0.03, FEAT_RUN: 0.02,
            DUMMY_RUN: 0.01}[run]


def in_band(dataset: str, run: str, micro_f1: float) -> bool:
    """Whether the table's 4-digit micro-F1 lies within the band."""
    return (abs(round(micro_f1, 4) - JAX_MICRO_F1[dataset, run])
            <= band(dataset, run) + 1e-9)


def proxy_specs(quick: bool) -> dict:
    """The generator specs of the JAX script (its ``gen_datasets``)."""
    return {
        "proxy-ppi": dict(
            num_nodes=4_000 if quick else 15_000, num_classes=121,
            feat_dim=50, avg_degree=29, alpha=1.0, multilabel=True,
            feature_snr=0.5, seed=11,  # weak features: aggregation helps
        ),
        "proxy-reddit": dict(
            num_nodes=10_000 if quick else 50_000, num_classes=41,
            feat_dim=602, avg_degree=60, alpha=1.0, multilabel=False,
            feature_snr=1.5, seed=12,
        ),
    }


def gen_datasets(root: str, quick: bool, names=DATASETS) -> dict:
    """Write each proxy of ``names`` and its train-subgraph walks (25
    walks of length 5 from every train node, NumPy seed 7) under
    ``root``; -> {name: (prefix, spec)}."""
    from graphsage_tpu_torch.data.synthetic import (
        make_powerlaw_graph,
        write_dataset,
    )
    from graphsage_tpu_torch.data.walks import run_random_walks, write_walks

    prefixes = {}
    for name, spec in proxy_specs(quick).items():
        if name not in names:
            continue
        prefix = os.path.join(root, name, name)
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        print(f"[gen] {name}: {spec}", flush=True)
        g = make_powerlaw_graph(**spec)
        write_dataset(g, prefix)
        deg = np.asarray([len(n) for n in g.neighbors])
        print(f"[gen] {name}: {len(g.edges)} edges, mean deg "
              f"{deg.mean():.1f}, p99 {np.percentile(deg, 99):.0f}, "
              f"max {deg.max()}", flush=True)
        is_train = g.is_train
        sub_neighbors = [
            nbrs[is_train[nbrs]] if is_train[i] else nbrs[:0]
            for i, nbrs in enumerate(g.neighbors)
        ]
        pairs = run_random_walks(
            sub_neighbors, np.flatnonzero(is_train), num_walks=25,
            walk_len=5, rng=np.random.default_rng(7),
        )
        write_walks(prefix + "-walks.txt", pairs, g.node_ids)
        prefixes[name] = (prefix, spec)
    return prefixes


def sup_flags(prefix: str, name: str, root: str, quick: bool, **kw):
    """The JAX script's ``sup_flags``: the acceptance protocol's
    TrainFlags (a tiny model in quick mode), updated by ``kw``."""
    from graphsage_tpu_torch.train.config import TrainFlags

    base = dict(
        train_prefix=prefix, base_log_dir=os.path.join(root, "logs", name),
        epochs=2 if quick else 10,
        max_total_steps=30 if quick else 10**9,
        batch_size=512, samples_1=25, samples_2=10,
        dim_1=128, dim_2=128, max_degree=128,
        validate_iter=5000, validate_batch_size=256,
        print_every=200, learning_rate=0.01, seed=123,
    )
    if quick:
        base.update(batch_size=64, samples_1=5, samples_2=5,
                    dim_1=16, dim_2=16, max_degree=32)
    base.update(kw)
    return TrainFlags(**base)


@dataclasses.dataclass
class Row:
    dataset: str
    run: str
    micro_f1: float
    macro_f1: float      # nan where the probe gives none
    wall_s: float
    note: str = ""


def supervised_row(prefix: str, name: str, spec: dict, model: str,
                   root: str, quick: bool, device) -> tuple[Row, dict]:
    """Train ``model`` with the acceptance flags; (its row, the
    trainer's result)."""
    from graphsage_tpu_torch.train.supervised import train as train_sup

    t0 = time.perf_counter()
    sigmoid = bool(spec["multilabel"])
    kw = dict(model=model, sigmoid=sigmoid)
    note = ""
    if sigmoid and not quick:
        # the pooled/seq models need ~4x the default 10 epochs to leave
        # the all-negative regime of the dense-multilabel sigmoid loss
        # on this proxy (RESULTS.md's footer); every model gets them
        kw["epochs"] = 40
        note = "40 ep"
    print(f"[sup] {name} {model} ...", flush=True)
    res = train_sup(sup_flags(prefix, name, root, quick, **kw),
                    device=device)
    wall = time.perf_counter() - t0
    print(f"[sup] {name} {model}: test micro-F1 {res['test_f1_mic']:.4f} "
          f"({wall:.1f} s)", flush=True)
    return Row(name, f"supervised {model}", float(res["test_f1_mic"]),
               float(res["test_f1_mac"]), wall, note), res


def probe_row(name: str, run: str, scores: dict, wall: float) -> Row:
    """A probe's row: positives-only micro-F1, with the reference's
    per-cell F1 in the note for multilabel data."""
    mic = scores.get("test_f1_pos", scores["test_f1"])
    note = (f"cell-F1 {scores['test_f1']:.4f}"
            if "test_f1_pos" in scores else "")
    return Row(name, run, float(mic), float("nan"), wall, note)


def dummy_row(name: str, scores: dict) -> Row:
    """The prior-predict baseline, from any probe's scores (it reads only
    the labels)."""
    mic = scores.get("dummy_f1_pos", scores["dummy_f1"])
    note = (f"cell-F1 {scores['dummy_f1']:.4f}"
            if "dummy_f1_pos" in scores else "")
    return Row(name, DUMMY_RUN, float(mic), float("nan"), 0.0, note)


def dataset_rows(prefix: str, name: str, spec: dict, runs, root: str,
                 quick: bool, device):
    """Yield the rows of ``runs`` for one proxy, in the JAX script's
    order."""
    from graphsage_tpu_torch.evaluation import evaluate_embeddings
    from graphsage_tpu_torch.train.unsupervised import train as train_unsup

    for model in SUPERVISED_MODELS:
        if f"supervised {model}" in runs:
            yield supervised_row(prefix, name, spec, model, root, quick,
                                 device)[0]

    # the SGD probe's epochs are capped at 15 on proxy-reddit, for the
    # probe and the baselines alike
    cap = 15 if name == "proxy-reddit" else None

    def probe(embed_dir):
        return evaluate_embeddings(prefix, embed_dir, "test", seed=1,
                                   sgd_max_iter=cap, device=device)

    scores = None
    if UNSUP_RUN in runs:
        t0 = time.perf_counter()
        flags = sup_flags(
            prefix, name, root, quick, model="graphsage_mean",
            learning_rate=1e-5 if quick else 2e-6,
            epochs=1, max_total_steps=60 if quick else 3000,
            max_degree=32 if quick else 100,
            random_context=True, save_embeddings=True,
        )
        print(f"[unsup] {name} ...", flush=True)
        res = train_unsup(flags, device=device)
        scores = probe(res["log_dir"])
        yield probe_row(name, UNSUP_RUN, scores, time.perf_counter() - t0)
    if FEAT_RUN in runs or (DUMMY_RUN in runs and scores is None):
        t0 = time.perf_counter()
        feat_scores = probe("feat")
        scores = scores or feat_scores
        if FEAT_RUN in runs:
            yield probe_row(name, FEAT_RUN, feat_scores,
                            time.perf_counter() - t0)
    if DUMMY_RUN in runs:
        yield dummy_row(name, scores)

    if N2V_RUN in runs:
        # node2vec (DeepWalk) over the same walks: plain SGD needs a
        # learning rate of O(1), and the test rows, which train only in
        # the retrain on the eval nodes, ~10 retrain epochs (the JAX
        # script's flags)
        t0 = time.perf_counter()
        flags = sup_flags(
            prefix, name, root, quick, model="n2v",
            learning_rate=2.0, dim_1=25,
            epochs=40, max_total_steps=100 if quick else 300_000,
            random_context=True, save_embeddings=True,
            n2v_test_epochs=2 if quick else 10,
        )
        print(f"[n2v] {name} ...", flush=True)
        res = train_unsup(flags, device=device)
        yield probe_row(name, N2V_RUN, probe(res["log_dir"]),
                        time.perf_counter() - t0)


# ------------------------------------------------------------- the table

HEADER = [
    "# Accuracy acceptance of the PyTorch port — power-law proxy datasets",
    "",
    "Written by `graphsage_tpu_torch/benchmarks/accuracy_acceptance.py`:",
    "the JAX package's acceptance protocol (`benchmarks/",
    "accuracy_acceptance.py`, the same generator specs, seeds, flags and",
    "rows) run through the port. `JAX micro-F1` is the JAX package's",
    "value from `benchmarks/RESULTS.md:25-42`; `band` is the half-width",
    "around it that the row is held to (the module's `band`); `beats raw",
    "features` is the JAX package's acceptance bar for a learned row.",
    "Metric: positives-only micro-F1 (multilabel cell accuracy in the",
    "notes as `cell-F1`). `wall(s)` is this table's device's time for the",
    "row: training, its sweeps and the probe.",
    "",
]
COLUMNS = ("dataset", "run", "test micro-F1", "macro-F1", "wall(s)",
           "JAX micro-F1", "band", "in band", "beats raw features",
           "notes")


def build_kernels() -> None:
    """Build the kernels the rows launch (K1 and K5/K6; one nvcc per
    source, started together) before any row, so that no row's wall
    time holds a build."""
    from concurrent.futures import ThreadPoolExecutor

    from graphsage_tpu_torch.ops import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        list(pool.map(build.build, ("gather_mean", "gather_mlp_pool")))
    print(f"[build] kernels current after {time.perf_counter() - t0:.1f} s",
          flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@dataclasses.dataclass
class Table:
    mode: str                  # "full" or "quick"
    device: str                # "cuda" or "cpu"
    cards: list                # nvidia-smi lines of the calls that wrote it
    rows: dict                 # (dataset, run) -> Row

    def add(self, row: Row) -> None:
        self.rows[row.dataset, row.run] = row

    def lines(self) -> list:
        out = list(HEADER)
        out.append(f"mode: {self.mode}; device: {self.device}")
        out += [f"card: {c}" for c in self.cards]
        out += ["", "| " + " | ".join(COLUMNS) + " |",
                "|" + "---|" * len(COLUMNS)]
        for name in DATASETS:
            feat = self.rows.get((name, FEAT_RUN))
            for run in RUNS:
                row = self.rows.get((name, run))
                if row is None:
                    continue
                if run in (FEAT_RUN, DUMMY_RUN):
                    beats = "—"
                elif feat is None:
                    beats = "no baseline yet"
                else:
                    beats = ("yes" if round(row.micro_f1, 4)
                             > round(feat.micro_f1, 4) else "NO")
                mac = ("—" if math.isnan(row.macro_f1)
                       else f"{row.macro_f1:.4f}")
                cells = (name, run, f"{row.micro_f1:.4f}", mac,
                         f"{row.wall_s:.1f}",
                         f"{JAX_MICRO_F1[name, run]:.4f}",
                         f"±{band(name, run):.2f}",
                         "yes" if in_band(name, run, row.micro_f1) else "NO",
                         beats, row.note)
                out.append("| " + " | ".join(cells) + " |")
        return out

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fp:
            fp.write("\n".join(self.lines()) + "\n")
        os.replace(tmp, path)


def read_table(path: str) -> Table:
    """A table this module wrote."""
    mode = device = None
    cards, rows = [], {}
    with open(path) as fp:
        for line in fp:
            line = line.rstrip("\n")
            if line.startswith("mode: "):
                m, d = line.split("; ")
                mode, device = m[len("mode: "):], d[len("device: "):]
            elif line.startswith("card: "):
                cards.append(line[len("card: "):])
            elif line.startswith("| proxy-"):
                cells = [c.strip() for c in line.strip("|").split(" | ")]
                name, run, mic, mac, wall = cells[:5]
                rows[name, run] = Row(
                    name, run, float(mic),
                    float("nan") if mac == "—" else float(mac),
                    float(wall), cells[9] if len(cells) > 9 else "")
    if mode is None:
        raise ValueError(f"{path}: no 'mode: ...; device: ...' line")
    return Table(mode, device, cards, rows)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small graphs, a tiny model, few steps")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="where the proxies and the logs are written")
    ap.add_argument("--datasets", default=",".join(DATASETS),
                    help="comma list, e.g. proxy-ppi")
    ap.add_argument("--runs", default=None,
                    help="comma list of row names, e.g. 'supervised gcn,"
                         "n2v + logreg' (default: every row)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.datasets = [d for d in args.datasets.split(",") if d]
    unknown = set(args.datasets) - set(DATASETS)
    if unknown:
        ap.error(f"unknown datasets {sorted(unknown)}; known: {DATASETS}")
    args.runs = ([r.strip() for r in args.runs.split(",") if r.strip()]
                 if args.runs else list(RUNS))
    unknown = set(args.runs) - set(RUNS)
    if unknown:
        ap.error(f"unknown runs {sorted(unknown)}; known: {RUNS}")
    return args


def main(argv=None) -> int:
    from graphsage_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    mode = "quick" if args.quick else "full"
    cards = []
    if device.type == "cuda":
        cards.append(card_line())
        build_kernels()
    table = Table(mode, device.type, cards, {})
    partial = (set(args.datasets) != set(DATASETS)
               or set(args.runs) != set(RUNS))
    if partial and os.path.exists(args.out):
        old = read_table(args.out)
        if (old.mode, old.device) != (mode, device.type):
            raise SystemExit(
                f"{args.out} holds a {old.mode} table on {old.device}; "
                f"this run is {mode} on {device.type}: pass another --out")
        table.rows = old.rows
        table.cards = old.cards + [c for c in cards if c not in old.cards]

    prefixes = gen_datasets(args.root, args.quick, args.datasets)
    for name, (prefix, spec) in prefixes.items():
        for row in dataset_rows(prefix, name, spec, args.runs, args.root,
                                args.quick, device):
            table.add(row)
            table.write(args.out)
    table.write(args.out)
    with open(args.out) as fp:
        print(fp.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
