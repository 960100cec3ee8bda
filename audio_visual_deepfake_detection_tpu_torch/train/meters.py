"""Console meters and metrics logging (JAX ``train/meters.py``): a JSONL
stream always, a tensorboard ``SummaryWriter`` when that package is there."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-9)


class MetricsLogger:
    """JSONL + optional tensorboard writer."""

    def __init__(self, folder: Optional[str]):
        self.folder = folder
        self._jsonl = None
        self._tb = None
        if folder:
            os.makedirs(folder, exist_ok=True)
            self._jsonl = open(os.path.join(folder, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(os.path.join(folder, "tb"))
            except Exception:  # noqa: BLE001 - tensorboard is optional
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **scalars}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for key, value in scalars.items():
                self._tb.add_scalar(key, value, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
