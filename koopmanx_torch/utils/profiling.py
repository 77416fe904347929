"""Timing and tracing helpers (counterpart of
``koopmanx/utils/profiling.py``).

- The program's spans and counters, off by default: :func:`span` names a
  stage of the control step (``kx.step``, ``kx.lift``, ``kx.qp_build``,
  ...) as a ``torch.profiler`` range, so that a profiler puts each device
  operation, and each idle gap of the device, under the span that was
  open on the host when it was launched; :func:`count` and
  :func:`count_device` add to named counters, the second on the device
  without a synchronization; :func:`counters` reads them all. Off, a span
  or a counter costs one test of a module-level flag: no range, no tensor,
  no kernel. :func:`enable` switches them on or off.
- :func:`trace`: a ``torch.profiler`` trace of the block with the spans
  on, written into a log directory (a Chrome trace, viewable in
  Perfetto) with the counters beside it.
- :func:`solves_per_second`, the headline rate, and :func:`time_fn`, the
  best-of wall time of a callable (the counterpart of ``time_jitted``).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

_on = False
_host: Dict[str, int] = collections.Counter()
# (name, device) -> a 0-d int64 tensor on that device
_device: Dict[tuple, torch.Tensor] = {}
_OFF = contextlib.nullcontext()


def synchronize(device=None) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.cuda.is_available() and (
            device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


def enable(on: bool = True) -> None:
    """Switch the spans and counters on or off, and reset the counters."""
    global _on
    _on = bool(on)
    _host.clear()
    _device.clear()


def enabled() -> bool:
    return _on


def span(name: str, args: Optional[Dict[str, object]] = None):
    """``with span("kx.qp_build"):`` a ``torch.profiler`` range around the
    block while the spans are on, else nothing. ``args`` holds identifiers
    of the span (``{"step": k}``); those that are ints are recorded as the
    range's keyword values, which the profiler keeps when it records
    shapes.

    The range is an operator-scope record (the profiler's fast record
    function), not a user annotation (``torch.profiler.record_function``):
    the profiler attaches a kernel launched outside any PyTorch operator
    (B1, launched through ``ctypes``) to the innermost operator-scope
    record open at its launch, and a user annotation is none, so under
    annotations B1 would count under ``kx.step``, or, with no span on,
    under nothing. An annotation also keeps no argument but a string,
    which the profiler drops."""
    if not _on:
        return _OFF
    kept = {k: v for k, v in (args or {}).items() if isinstance(v, int)}
    return torch._C._profiler._RecordFunctionFast(name, (), kept)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` (spans on)."""
    if _on:
        _host[name] += int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d integer tensor ``t`` to the counter ``name`` on ``t``'s
    device, without waiting for the device (spans on). The caller computes
    ``t`` only where :func:`enabled` says so."""
    if _on:
        key = (name, t.device)
        held = _device.get(key)
        _device[key] = (t.to(torch.int64) if held is None
                        else held + t)  # out of place: inference tensors


def counters() -> Dict[str, int]:
    """Every counter as a plain int; reads each device's counters at once
    (one synchronization a device)."""
    out = dict(_host)
    by_device = collections.defaultdict(list)
    for (name, dev), t in _device.items():
        by_device[dev].append((name, t))
    for items in by_device.values():
        values = torch.stack([t for _, t in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0) + int(v)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace(dir): run()``: a ``torch.profiler`` trace of the block
    (the CPU, and the card where there is one; shapes recorded, so that
    ``kx.step`` shows its step) with the spans on, written to
    ``dir/trace.json``, and the counters to ``dir/counters.json``; yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was = _on
    enable(True)
    try:
        with profile(activities=activities, record_shapes=True) as prof:
            yield prof
            synchronize()
        read = counters()
    finally:
        enable(was)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(read, f, indent=1, sort_keys=True)


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
