"""Ranges around the program's layers, and the reading of a profiled
stretch.

The ranges are the benchmark's own: :func:`install_ranges` wraps, for the
life of a traced run, the factories that ``engine/loop.py`` and
``engine/controller.py`` import from ``engine/core.py`` (each callable they
return runs inside a ``torch.profiler.record_function`` range),
``core.synthesize_terminal``, the box QP's solve in ``control/qp.py`` and
the pipeline's dictionary, as ``tools/profile_torch_step.py`` does.
:class:`Stretches` profiles two stretches of a window: one on the device
alone, which gives the device's busy time (the union of its operations'
intervals), the stretch's wall time, the operations and their top by
time; then one with the host's operations and the ranges, which gives the
device time under each range (each device operation counted once, under
the ranges open on the host when the operation it is attached to began)
and the idle gaps by the range open on the host. The host's own profiling
would slow the first stretch's host, and read as device idle time.
"""
from __future__ import annotations

import bisect
import collections
import functools
import time
from typing import Dict

import torch

RANGES = ("lift", "control_solve", "qp_solve", "terminal", "estimator",
          "plant")
# host events of the CUDA runtime waiting on a full launch queue: the
# profiler attaches to them a copy of a device operation that a host
# operation already holds
STALLS = ("Command Buffer Full", "Buffer Flush")


def _ranged(fn, name: str):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return inner


def _ranged_factory(factory, name: str):
    @functools.wraps(factory)
    def make(*args, **kwargs):
        return _ranged(factory(*args, **kwargs), name)

    return make


def install_ranges() -> None:
    """Wrap the program's layers in named ranges, for the rest of the
    process. Call before the pipeline is built."""
    from koopmanx_torch.control import qp
    from koopmanx_torch.engine import controller, core, loop

    plan = [(loop, "make_control_solver", "control_solve", True),
            (loop, "make_estimator_update", "estimator", True),
            (loop, "make_step", "plant", True),
            (controller, "make_control_solver", "control_solve", True),
            (controller, "make_estimator_update", "estimator", True),
            (core, "synthesize_terminal", "terminal", False),
            (qp, "solve_box_qp_batch_kernel", "qp_solve", False),
            (qp, "solve_box_qp", "qp_solve", False)]
    for module, attr, name, factory in plan:
        wrap = _ranged_factory if factory else _ranged
        setattr(module, attr, wrap(getattr(module, attr), name))


def range_dictionary(dictionary) -> None:
    """Every call of ``dictionary`` (an ``nn.Module``) inside a ``lift``
    range."""
    dictionary.forward = _ranged(dictionary.forward, "lift")


def _device_spans(prof):
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name not in RANGES
                  and not e.name.startswith("aten::"))


def _busy_and_gaps(spans):
    """The union of the intervals' length, and the gaps between them."""
    busy, reach, gaps = 0.0, None, []
    for start, end, _ in spans:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        if reach is None or end > reach:
            busy += end - (start if reach is None else max(start, reach))
            reach = end
    return busy, gaps


def read_device(prof, window_s: float, top: int = 10) -> Dict[str, object]:
    """A stretch profiled on the device alone: its busy time, its wall time
    (``window_s`` seconds of the host's clock, synchronized at both ends),
    its operations and the ``top`` of them by time."""
    spans = _device_spans(prof)
    by_name = collections.defaultdict(float)
    for start, end, name in spans:
        by_name[name] += end - start
    busy, _ = _busy_and_gaps(spans)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_us": busy, "window_us": window_s * 1e6,
            "device_ops": len(spans),
            "device_top": [[name[:120], us * 1e-6] for name, us in top_ops]}


def _outermost(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals:
    a range nested in one of its own name counts once."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(intervals, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


def read_ranges(prof, top: int = 10) -> Dict[str, object]:
    """A stretch profiled with the host's operations and the ranges: the
    device time of the operations launched under each range, and the
    device's idle time by the innermost range open on the host at the
    middle of each gap.

    A device operation counts under a range where the host operation the
    profiler attached it to (by its correlation) started inside that
    range's interval on the host; a range nested in one of its own name
    counts once. Each device operation of the stretch is counted once,
    the host's operations claiming theirs before the launch stalls
    (``STALLS``) that the profiler attaches copies to: an attachment that
    finds no device operation of its name and length left (a copy, or a
    range's own device-side annotation, whose span holds idle time) is
    dropped, and the dropped ones are reported by their host operation.
    Raises ``ValueError`` where the operations under ranges that no other
    range holds still add up to more than the stretch's busy time."""
    from torch.autograd import DeviceType

    spans = _device_spans(prof)
    left = collections.Counter((name, round(end - start, 3))
                               for start, end, name in spans)
    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    hosts = [(e.time_range.start, e.time_range.end, e.name)
             for e in events if e.name in RANGES]
    launches = []
    dropped = collections.defaultdict(lambda: [0, 0.0])
    # the host's operations claim their device operations first, then the
    # launch stalls the profiler attached copies of them to
    for stalls in (False, True):
        for e in events:
            if (e.name in STALLS) != stalls:
                continue
            for k in e.kernels:
                key = (k.name, round(k.duration, 3))
                if left[key] > 0:
                    left[key] -= 1
                    launches.append((e.time_range.start, k.duration))
                else:
                    slot = dropped[f"{e.name} <- {k.name}"[:120]]
                    slot[0] += 1
                    slot[1] += k.duration
    by_name = {}
    for name in RANGES:
        union = _outermost((s, t) for s, t, n in hosts if n == name)
        if union:
            by_name[name] = (union, [s for s, _ in union])
    every = _outermost((s, t) for s, t, _ in hosts)
    every_starts = [s for s, _ in every]
    stage_us = dict.fromkeys(by_name, 0.0)
    top_us = 0.0
    for t, us in launches:
        for name, (union, starts) in by_name.items():
            if _inside(union, starts, t):
                stage_us[name] += us
        if _inside(every, every_starts, t):
            top_us += us
    busy, gaps = _busy_and_gaps(spans)
    if top_us > busy * (1.0 + 1e-6) + 1.0:
        raise ValueError(f"the ranges hold {top_us:.1f} us of device time, "
                         f"more than the stretch's busy {busy:.1f} us")
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = [(s, name) for s, e, name in hosts if s <= mid <= e]
        idle[max(inside)[1] if inside else "outside the ranges"] += g1 - g0
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    worst_dropped = sorted(dropped.items(), key=lambda kv: -kv[1][1])[:top]
    return {"stage_us": {k: v for k, v in stage_us.items() if v},
            "ranged_us": top_us, "ranges_busy_us": busy,
            "dropped": [[name, n, us] for name, (n, us) in worst_dropped],
            "idle_top": [[name, us * 1e-6] for name, us in top_idle]}


class Stretches:
    """Two profiled stretches of ``units`` chunks or calls each, from when
    ``at`` are done: the first on the device alone (busy and wall time,
    operations: the host runs at its own pace), the second with the host's
    operations and the benchmark's ranges (the device time under each
    range, the idle gaps by range; the host runs slower under it). Call
    :meth:`tick` with the number of units done, before the first and after
    each."""

    def __init__(self, at: int, units: int, device):
        self.at, self.units, self.device = at, units, device
        self.prof = self.t0 = None
        self.done = {}

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, activities) -> None:
        from torch.profiler import profile

        self._sync()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def _stop(self, name: str) -> None:
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done[name] = (self.prof, wall)
        self.prof = None

    def tick(self, done: int) -> None:
        from torch.profiler import ProfilerActivity

        on_card = torch.device(self.device).type == "cuda"
        if done == self.at:
            self._start([ProfilerActivity.CUDA if on_card
                         else ProfilerActivity.CPU])
        elif done == self.at + self.units:
            self._stop("device")
            self._start([ProfilerActivity.CPU, ProfilerActivity.CUDA])
        elif done == self.at + 2 * self.units:
            self._stop("ranges")

    @property
    def finished(self) -> bool:
        return "ranges" in self.done

    def read(self) -> Dict[str, object]:
        dev = read_device(*self.done["device"])
        ranges = read_ranges(self.done["ranges"][0])
        return dict(dev, stage_us=ranges["stage_us"],
                    ranged_us=ranges["ranged_us"],
                    ranges_busy_us=ranges["ranges_busy_us"],
                    dropped=ranges["dropped"],
                    breakdown={"device_ops": dev.pop("device_top"),
                               "idle_gaps": ranges["idle_top"]})
