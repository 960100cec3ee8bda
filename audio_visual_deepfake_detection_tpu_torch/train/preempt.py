"""Preemption-safe training shutdown (JAX ``train/preempt.py``).

Managed fleets deliver a SIGTERM and a grace window before eviction.
``PreemptionGuard`` turns that into a clean stop: the handler only sets a
flag, the train loop polls it at iteration boundaries, writes a mid-epoch
checkpoint and returns.

With several processes the flag is per process, but all must leave the step
loop at the same iteration. ``agreed()`` is therefore an all-reduce (max)
over the default ``torch.distributed`` group when one is initialised, and
must be called at the same iteration index by every process (the loop polls
on a fixed cadence, so it is).
"""

from __future__ import annotations

import signal

import torch


class PreemptionGuard:
    """Install once near process start (main thread); pass to
    ``train_one_epoch``. ``triggered`` flips after a loop has acted on the
    request (checkpoint written, loop exited)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self.triggered = False
        self._prev = {}
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self._flag = True

    def request(self):
        """Programmatic trigger (tests, orchestrators)."""
        self._flag = True

    def requested(self) -> bool:
        """This process's own flag; with several processes use ``agreed()``."""
        return self._flag

    def agreed(self) -> bool:
        """True iff any process was signalled. Collective when a process
        group with more than one member is initialised."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
            flag = torch.tensor(int(self._flag), device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return bool(flag.item())
        return self._flag

    def restore(self):
        """Re-install the previous handlers (tests)."""
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
