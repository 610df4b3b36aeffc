"""The port stands alone: importing every module of graphsage_tpu_torch
and chip_smoke.py pulls in nothing of JAX and nothing of graphsage_tpu,
and chip_smoke.py refuses to run without a CUDA device."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "sklearn", "graphsage_tpu")

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import graphsage_tpu_torch
names = [m.name for m in pkgutil.walk_packages(graphsage_tpu_torch.__path__,
                                               "graphsage_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("infer", "ops.gather", "ops.philox", "ops.pool",
                 "ops.gather_probe", "benchmarks.gather_probe",
                 "nn.lstm", "parallel.dp", "parallel.distributed",
                 "parallel.graph_sharded", "parallel.launch",
                 "train.supervised", "train.sharding", "train.tblog",
                 "data.minibatch",
                 "nn.prediction", "nn.negative", "data.walks",
                 "models.unsupervised", "train.unsupervised",
                 "models.node2vec", "evaluation", "data.native",
                 "nn.metrics", "data.synthetic",
                 "benchmarks.accuracy_acceptance", "benchmarks.seed_study",
                 "benchmarks.probe_breakdown", "benchmarks.ring_timeline",
                 "benchmarks.bench", "benchmarks.agg_sweep",
                 "benchmarks.serving_bench", "benchmarks.step_profile",
                 "benchmarks.sampler_probe", "benchmarks.scaling_probe",
                 "benchmarks.halo_probe", "cli"):
        assert f"graphsage_tpu_torch.{name}" in seen["modules"]
    bad = [m for m in seen["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env={**_env(), "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
