"""The trainers' instrumentation: training scalars to ``metrics.jsonl``
and histograms to ``histograms.jsonl`` in the log dir and, when
``torch.utils.tensorboard`` imports, to TensorBoard event files too
(``ScalarLogger``); the activations probe of ``--log_histograms``
(``histogram_probe``); the ``torch.profiler`` window of
``--profile_dir`` (``TrainingProfile``)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from graphsage_tpu_torch.models.graphsage import SAGEConfig, sage_embed

HISTOGRAM_BINS = 30


class ScalarLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._dir = log_dir
        self._fp = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:   # tensorboard is not installed
            self._tb = None

    def log(self, step: int, **scalars):
        rec = {"step": step, "ts": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), step)
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()

    def log_histograms(self, step: int, tensors: dict,
                       prefix: str = "params"):
        """One record per tensor in ``histograms.jsonl`` (min, max, mean,
        std and counts of ``HISTOGRAM_BINS`` equal bins between min and
        max) and, with TensorBoard, one histogram: every parameter's
        (``prefix`` "params") or a probe's activations (``prefix``
        "")."""
        with open(os.path.join(self._dir, "histograms.jsonl"), "a") as fp:
            for key, value in tensors.items():
                name = f"{prefix}/{key}" if prefix else key
                x = value.detach().float().flatten()
                if x.numel() == 0:
                    continue
                lo, hi = x.min(), x.max()
                counts = torch.histc(x, HISTOGRAM_BINS, float(lo), float(hi))
                rec = {"step": step, "name": name, "min": float(lo),
                       "max": float(hi), "mean": float(x.mean()),
                       "std": float(x.std(correction=0)),
                       "counts": counts.cpu().int().tolist()}
                fp.write(json.dumps(rec) + "\n")
                if self._tb is not None:
                    self._tb.add_histogram(name, x.cpu().numpy(), step)

    def close(self):
        self._fp.close()
        if self._tb is not None:
            self._tb.close()


class TrainingProfile:
    """``torch.profiler`` (host, and the card's kernels on ``cuda``) from
    construction to ``stop``, which writes its Chrome trace into
    ``profile_dir`` and returns the file's path."""

    def __init__(self, profile_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        self.profile_dir = profile_dir
        self.device = device
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        path = os.path.join(self.profile_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(path)
        print(f"Profile trace written to {path}")
        return path


def histogram_probe(sage: SAGEConfig, graph, batch_size: int, seed: int,
                    device):
    """probe(params, features, adj) -> {name: tensor}: the deterministic
    forward's activations (``acts/input``, ``acts/layer_<L>/hop_<H>``)
    over a batch of train nodes, the sampler seeded ``seed`` at every
    call, for ``--log_histograms``."""
    ids = torch.from_numpy(np.resize(np.flatnonzero(graph.is_train),
                                     batch_size).astype(np.int32)).to(device)

    @torch.inference_mode()
    def probe(params, features, adj):
        capture: dict = {}
        sage_embed(params, features, adj, ids, sage,
                   generator=torch.Generator(device=device).manual_seed(
                       seed),
                   deterministic=True, capture=capture)
        return capture

    return probe
