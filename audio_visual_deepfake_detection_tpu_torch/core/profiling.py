"""Profiling and tracing hooks (JAX ``core/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that records host (CPU) activity, and the card's kernels too when the
  process has a card, and writes a Chrome trace (``chrome://tracing``,
  Perfetto) into ``logdir`` as ``trace_<pid>_<ns>.json``. It yields the
  profiler, whose ``key_averages()`` and ``events()`` the caller may read.
  The port's kernels are launched from a plain C library, not from PyTorch
  operators; CUPTI records every kernel of the process's context, so they
  appear under their ``__global__`` names all the same. A trace taken in a
  process after other processes have used the card may lack some of its
  first kernel events (``tools/profiler_session_drops.py`` counts them);
  take it in a fresh process where every kernel must be there.
- ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``).
- ``StepTimer``: a wall-clock meter that synchronizes the card before it
  reads the clock, reporting seconds a step every ``sync_every`` steps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    os.makedirs(logdir, exist_ok=True)
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)


def _first_cuda_tensor(value):
    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    items = value.values() if isinstance(value, dict) else \
        value if isinstance(value, (list, tuple)) else ()
    for v in items:
        found = _first_cuda_tensor(v)
        if found is not None:
            return found
    return None


class StepTimer:
    def __init__(self, sync_every: int = 20):
        self.sync_every = sync_every
        self.count = 0
        self.total = 0.0
        self._start = time.perf_counter()

    def step(self, sync_value=None) -> Optional[float]:
        """Call once per step; returns seconds/step every sync_every steps.
        ``sync_value`` (a tensor, or a dict, list or tuple of them): the
        device of its first CUDA tensor is synchronized before the clock is
        read, so the steps' queued work is inside the reading."""
        self.count += 1
        if self.count % self.sync_every == 0:
            t = _first_cuda_tensor(sync_value) if sync_value is not None else None
            if t is not None:
                torch.cuda.synchronize(t.device)
            now = time.perf_counter()
            per_step = (now - self._start) / self.sync_every
            self.total += now - self._start
            self._start = now
            return per_step
        return None
