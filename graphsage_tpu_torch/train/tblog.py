"""Training scalars to ``metrics.jsonl`` in the log dir and, when
``torch.utils.tensorboard`` imports, to TensorBoard event files too."""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
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

    def close(self):
        self._fp.close()
        if self._tb is not None:
            self._tb.close()
