"""Timing and tracing helpers (counterpart of
``koopmanx/utils/profiling.py``).

- :class:`StepTimer`: wall time per named phase, each phase ending on a
  device synchronization (``torch.cuda.synchronize()`` on the card, the
  counterpart of the JAX package's barrier), so that a phase owns the
  device work it issued.
- :func:`trace`: a ``torch.profiler`` trace of the block, written into a
  log directory (a Chrome trace, viewable in Perfetto).
- :func:`solves_per_second`, the headline rate, and :func:`time_fn`, the
  best-of wall time of a callable (the counterpart of ``time_jitted``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def synchronize(device=None) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates wall time per named phase (device-synchronized)."""

    def __init__(self, device=None) -> None:
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): run()``: a ``torch.profiler`` trace of the block
    (the CPU, and the card where there is one) written to
    ``dir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def solves_per_second(batch: int, steps: int, wall_s: float) -> float:
    return batch * steps / wall_s


def time_fn(fn, *args, reps: int = 3, device=None) -> float:
    """Best-of-``reps`` wall time (s) of ``fn(*args)``, each call ending
    on a device synchronization, after one warm-up call."""
    fn(*args)
    synchronize(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best
