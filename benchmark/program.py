"""The program's own spans and counters, read in a profiled stretch of a
sweep.

``koopmanx_torch.utils.profiling`` names the stages of the control step
inside the program (``kx.step``, ``kx.lift``, ``kx.control_solve``,
``kx.qp_build``, ``kx.qp_solve``, ``kx.kkt_inverse``, ``kx.admm``,
``kx.terminal``, ``kx.plant``, ``kx.estimator``, ``kx.model_guard``) and
counts rows where the work happens (``step.rows``, ``lift.rows``,
``model_guard.rows`` / ``.held``, ``terminal.rows`` / ``.held``). Off by
default; :func:`stretch` turns them on for a few chunks under
``torch.profiler`` (the host and the device). The two stretches of
:class:`benchmark.trace.Stretches` run with them off. A program without
them (an older commit) gives no stretch. ``benchmark/tools/spans.py``
runs such a stretch after a cell's traced window.

:func:`read` attributes the device operations as
:func:`benchmark.trace.read_ranges` does: each counts once, under the
spans open on the host when the host operation it is attached to began,
the host's operations claiming theirs before the launch stalls do; the
device-side annotations of the benchmark's ranges (and any device event
named as a span) are not operations. The spans are operator-scope
records, so the profiler attaches a kernel launched outside any PyTorch
operator (B1, through ``ctypes``) to the innermost span open at its
launch. A span's self time is the device time under it and under none of
the spans it holds.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Optional

import torch

from .trace import RANGES, STALLS, _busy_and_gaps, _outermost

PREFIX = "kx."
STEP = "kx.step"
# each span that times the work of one of the benchmark's ranges
SAME_WORK = {"kx.lift": "lift", "kx.control_solve": "control_solve",
             "kx.terminal": "terminal", "kx.qp_solve": "qp_solve",
             "kx.plant": "plant", "kx.estimator": "estimator"}


def stretch(run, units: int, steps: int, device) -> Optional[dict]:
    """``run()`` ``units`` times (``steps`` control steps in all) under the
    profiler with the program's spans and counters on; their reading, or
    None where the program has no spans."""
    from torch.profiler import ProfilerActivity, profile

    from koopmanx_torch.utils import profiling

    if not hasattr(profiling, "enable"):
        return None
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiling.synchronize(device)
    profiling.enable(True)
    try:
        with profile(activities=activities) as prof:
            for _ in range(units):
                run()
            profiling.synchronize(device)
        counters = profiling.counters()
    finally:
        profiling.enable(False)
    return dict(read(prof), steps=steps, counters=counters)


def _device_ops(prof):
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in RANGES and not e.name.startswith(PREFIX)
                  and not e.name.startswith("aten::"))


def read(prof, top: int = 10) -> Dict[str, object]:
    """The device time under each span and under each of the benchmark's
    ranges, each span's self time, the busy time, and the idle gaps by the
    innermost span open on the host at their middle. Raises
    ``ValueError`` where the ``kx.step`` spans hold more device time than
    the stretch was busy."""
    from torch.autograd import DeviceType

    ops = _device_ops(prof)
    left = collections.Counter((name, round(end - start, 3))
                               for start, end, name in ops)
    events = sorted((e for e in prof.events()
                     if e.device_type != DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    launches = []
    dropped = collections.defaultdict(lambda: [0, 0.0])
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
    named = collections.defaultdict(list)
    for e in events:
        if e.name.startswith(PREFIX) or e.name in RANGES:
            named[e.name].append((e.time_range.start, e.time_range.end))
    unions = {name: _outermost(iv) for name, iv in named.items()}
    starts = {name: [s for s, _ in union] for name, union in unions.items()}

    def holding(t):
        """The spans and ranges open on the host at ``t``, each with the
        start of its interval that holds ``t``."""
        out = {}
        for name, union in unions.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and t <= union[i][1]:
                out[name] = union[i][0]
        return out

    def innermost(open_):
        began = [(s, n) for n, s in open_.items() if n.startswith(PREFIX)]
        return max(began)[1] if began else None

    under = dict.fromkeys(unions, 0.0)
    own = collections.defaultdict(float)
    for t, us in launches:
        open_ = holding(t)
        for name in open_:
            under[name] += us
        inner = innermost(open_)
        if inner is not None:
            own[inner] += us
    busy, gaps = _busy_and_gaps(ops)
    if under.get(STEP, 0.0) > busy * (1.0 + 1e-6) + 1.0:
        raise ValueError(f"the {STEP} spans hold {under[STEP]:.1f} us of "
                         f"device time, more than the stretch's busy "
                         f"{busy:.1f} us")
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        inner = innermost(holding(0.5 * (g0 + g1)))
        idle[inner or f"outside {STEP}"] += g1 - g0
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    worst_dropped = sorted(dropped.items(), key=lambda kv: -kv[1][1])[:top]
    return {"busy_us": busy, "device_ops": len(ops),
            "span_us": {k: v for k, v in under.items()
                        if k.startswith(PREFIX) and v},
            "self_us": {k: v for k, v in own.items() if v},
            "range_us": {k: v for k, v in under.items()
                         if k in RANGES and v},
            "idle_top": [[name, us * 1e-6] for name, us in top_idle],
            "dropped": [[name, n, us] for name, (n, us) in worst_dropped]}


def summary(prog: dict) -> str:
    """The stretch in a few lines for standard error: each span's device
    ms a step beside the benchmark's range of the same work, the idle gaps
    by span, the counters."""
    steps = prog["steps"]
    ms = lambda us: f"{us / steps / 1e3:.4f}"
    parts = []
    for name, us in sorted(prog["span_us"].items(), key=lambda kv: -kv[1]):
        same = SAME_WORK.get(name)
        beside = (f" (range {same} {ms(prog['range_us'][same])})"
                  if same in prog["range_us"] else "")
        parts.append(f"{name} {ms(us)}{beside}")
    self_ms = ", ".join(f"{k} {ms(v)}" for k, v in
                        sorted(prog["self_us"].items(), key=lambda kv: -kv[1]))
    idle = ", ".join(f"{k} {s * 1e3 / steps:.4f}" for k, s in prog["idle_top"])
    return (f"program spans, device ms a step over {steps} steps: "
            + "; ".join(parts)
            + f"\nprogram spans' self ms a step: {self_ms}"
            + f"\nprogram stretch busy {prog['busy_us']:.1f} us, "
            f"{prog['device_ops']} device operations; idle ms a step by the "
            f"innermost span open: {idle}"
            + f"\nprogram counters: {prog['counters']}")

