#!/usr/bin/env python
"""Serving-path latency and throughput of the PyTorch port:
``Controller.step`` and ``BatchedController.step`` (counterpart of
``tools/bench_serving.py``).

The engine bench (``python -m koopmanx_torch.bench``) measures the
batched loop, 200 steps a run. Serving is the opposite regime: ONE control
step per call, state carried across calls. This measures:

- single-plant ``Controller.step(x)`` latency,
- ``BatchedController.step(X)`` latency for plant fleets (``--batches``),
  with the box-ADMM kernel's launches over the timed calls,
- the empty-dispatch baseline: one ``a + 1.0`` on an (8, 8) device tensor
  followed by ``torch.cuda.synchronize()``, so that the device's share of
  a call can be told from the host's cost of reaching the device.

Each timed call starts with the device idle and includes the caller's
read of u to the host. The config is ``tools/bench_serving.py``'s:
``duffing_nn_preset`` with 10 steps, N = 20, 25 x 25 data and the MLP lift
(nlift 8); the kernel route on the card, the plain route with ``--cpu``.
The JSON lines have the JAX tool's keys, times unrounded, plus ``p50_ms``,
``calls``, ``box_admm_launches`` and the card's name and power limit.

``--curve`` measures single-plant latency against program size under the
JAX tool's six step programs and the empty dispatch (``tiny_identity``).
The JAX tool's ``hlo_ops`` (the compiled program's instruction count) has
no counterpart in eager PyTorch: in its place each row has
``device_ops``, the device operations (kernels, copies, fills) a call,
counted from the profiler's device events as ``chip_smoke.py``'s
``device_ops_per_call`` counts them (null on the CPU, which has none).

Run: python tools/bench_serving_torch.py [--cpu] [--batches 1,256,4096]
     [--reps 20] [--curve]
Without ``--cpu`` it runs on the card and raises without one. It imports
no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# the curve's step programs: (update mode, ADMM iterations, horizon)
VARIANTS = (
    ("full", ("rls_sqrt", 60, 20)),
    ("no_update", ("off", 60, 20)),
    ("admm20", ("rls_sqrt", 20, 20)),
    ("admm5", ("rls_sqrt", 5, 20)),
    ("horizon10", ("rls_sqrt", 60, 10)),
    ("lean", ("off", 20, 10)),
)


def build(device, update="rls_sqrt", qp_iters=60, horizon=20):
    """``tools/bench_serving.py``'s serving pipeline on ``device``."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.run import build_pipeline

    cfg = C.duffing_nn_preset()
    cfg.steps = 10
    cfg.mpc.horizon = horizon
    cfg.mpc.qp_iters = qp_iters
    cfg.mpc.qp_backend = "pallas" if device.type == "cuda" else "xla"
    cfg.update.mode = update
    cfg.data = C.DataConfig(n_step=25, n_traj=25)
    cfg.lift = C.LiftConfig(kind="mlp", nlift=8)
    return build_pipeline(cfg, device=device)


def _sync(device):
    return torch.cuda.synchronize if device.type == "cuda" else lambda: None


def _timeit(fn, device, reps):
    """``fn()`` once to warm, then ``reps`` timed calls, each started with
    the device idle: their wall seconds and the box-ADMM kernel's launches
    in them."""
    from koopmanx_torch.ops.box_admm import box_admm

    sync = _sync(device)
    fn()
    walls, before = [], box_admm.launches
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return torch.tensor(walls, dtype=torch.float64), box_admm.launches - before


def _times(walls):
    return {"best_ms": float(walls.min()) * 1e3,
            "mean_ms": float(walls.mean()) * 1e3,
            "p50_ms": float(walls.quantile(0.5)) * 1e3}


def device_ops(fn, device, calls: int = 3):
    """Device operations a call of ``fn`` (kernels, copies, fills), from
    the profiler's device-side events; None on the CPU."""
    if device.type != "cuda":
        return None
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith("aten::")) / calls


def _empty_dispatch(device):
    """The empty dispatch: ``a + 1.0`` on an (8, 8) tensor, then a
    synchronize."""
    dummy = torch.zeros((8, 8), dtype=torch.float32, device=device)
    sync = _sync(device)
    return lambda: (dummy + 1.0, sync())


def _emit(rows, record):
    print(json.dumps(record), flush=True)
    rows.append(record)


def curve_main(args, device, where):
    """Single-plant latency against the step program's size."""
    from koopmanx_torch.engine.controller import Controller

    rows, curve = [], []
    for name, (update, iters, horizon) in VARIANTS:
        pipe = build(device, update, iters, horizon)
        ctrl = Controller.from_pipeline(pipe)
        x0 = pipe.x_init
        one = lambda: ctrl.step(x0).cpu()
        walls, _ = _timeit(one, device, args.reps)
        ops = device_ops(lambda: ctrl.step(x0), device)
        curve.append({"variant": name, "device_ops": ops, **_times(walls)})
        _emit(rows, curve[-1])
    ident = _empty_dispatch(device)
    walls, _ = _timeit(ident, device, args.reps)
    curve.append({"variant": "tiny_identity",
                  "device_ops": device_ops(lambda: ident()[0], device),
                  **_times(walls)})
    _emit(rows, {"curve": curve, **where})
    return rows


def main(argv=None):
    """Print the JSON lines; return them as a list of dicts."""
    from koopmanx_torch.device import card_line, resolve_device
    from koopmanx_torch.engine.controller import BatchedController, Controller

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain route)")
    ap.add_argument("--batches", default="1,256,4096")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--curve", action="store_true",
                    help="measure the dispatch-latency-vs-program-size "
                         "curve instead of the fleet table")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    where = {"device": torch.cuda.get_device_name(device) if on_card
             else "cpu", "card": card_line() if on_card else None}
    if args.curve:
        return curve_main(args, device, where)

    rows = []
    pipe = build(device)
    base, _ = _timeit(_empty_dispatch(device), device, args.reps)
    x0 = pipe.x_init
    ctrl = Controller.from_pipeline(pipe)
    walls, launches = _timeit(lambda: ctrl.step(x0).cpu(), device, args.reps)
    _emit(rows, {
        "metric": "serving Controller.step latency (single plant)",
        **_times(walls), "calls": args.reps, "box_admm_launches": launches,
        "dispatch_baseline_ms": float(base.min()) * 1e3,
        "est_device_ms": float(walls.min() - base.min()) * 1e3,
        **where,
    })
    for b in [int(v) for v in args.batches.split(",") if int(v) > 1]:
        fleet = BatchedController.from_pipeline(pipe, b)
        xb = x0.expand((b,) + x0.shape)
        walls, launches = _timeit(lambda: fleet.step(xb).cpu(), device,
                                  args.reps)
        best = float(walls.min())
        _emit(rows, {
            "metric": f"serving BatchedController.step latency (fleet={b})",
            **_times(walls), "calls": args.reps,
            "box_admm_launches": launches,
            "per_plant_us": best / b * 1e6,
            "solves_per_s": b / best,
            **where,
        })
    return rows


if __name__ == "__main__":
    main()
