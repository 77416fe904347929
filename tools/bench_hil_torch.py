#!/usr/bin/env python
"""Hardware-in-the-loop serving of the PyTorch port: the native C++ plant
on the host, the port's controller on the card.

The plant steps outside the torch program (``csrc/plant_sim.cpp`` through
``koopmanx_torch.systems.native``, standing in for external hardware);
only the serving ``Controller`` (one plant) or ``BatchedController``
(``--fleet B``) runs on the device. Every control period pays the whole
round trip: the measurement x copied to the card, the controller's step,
the read of u back to the host (cast to float64), and the C++ plant step.
The JSON line has the per-period latency percentiles against the plant's
real-time budget, the plant step's share of the period, and the
closed-loop tracking metrics, so that the latency belongs to a loop that
controls its plant; on the card also the card's name and power limit.

Run: python tools/bench_hil_torch.py [--preset pendulum] [--steps 600]
     [--fleet B] [--dtype float64] [--cpu]
Without ``--cpu`` it runs on the card (raising without one) through the
box-ADMM kernel; with ``--cpu`` on the plain route. It imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def build(preset: str, steps: int, cpu: bool, dtype: str = None):
    """The preset's config (the kernel route on the card, the plain one on
    the CPU) and its pipeline on that device."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.run import build_pipeline

    cfg = C.PRESETS[preset]()
    cfg.steps = steps
    cfg.mpc.qp_backend = "xla" if cpu else "pallas"
    if dtype:
        cfg.dtype = dtype
    return cfg, build_pipeline(cfg, device="cpu" if cpu else None)


def _percentiles(t: np.ndarray, keys=(50, 90, 99)) -> dict:
    return {f"p{k}": float(np.percentile(t, k)) * 1e3 for k in keys}


def serve(cfg, pipe, steps: int, fleet: int = 0, on_period=None) -> dict:
    """Serve the pipeline's plant (``fleet`` 0: one ``Controller`` from
    ``x_init``; else a ``BatchedController`` of ``fleet`` plants from
    ``x_init`` scaled by U[0.5, 1.5] per plant, seed 0) against the native
    plant for ``steps`` periods, the parameters switching past
    ``cfg.switch_step`` as in the loop. ``on_period(k)`` is called before
    each period's step. Returns the timings (s, per period) and the states
    after each period, float64 on the host."""
    from koopmanx_torch.engine.controller import BatchedController, Controller
    from koopmanx_torch.systems.library import get_system
    from koopmanx_torch.systems.native import native_step, native_step_batch

    system = get_system(cfg.system)
    h, integ = cfg.data.h, cfg.integrator
    x0 = pipe.x_init.detach().cpu().double().numpy()
    if fleet:
        ctrl = BatchedController.from_pipeline(pipe, fleet)
        x = x0[None, :] * np.random.default_rng(0).uniform(0.5, 1.5,
                                                           (fleet, 1))
        if system.clamp is not None:
            x = np.maximum(x, 0.0)
        plant = lambda x, u, th: native_step_batch(system, x, u, th, h, integ)
    else:
        ctrl = Controller.from_pipeline(pipe)
        x = x0
        plant = lambda x, u, th: native_step(system, x, u, th, h, integ)
    to_card = lambda x: torch.as_tensor(x, dtype=ctrl.dtype,
                                        device=ctrl.device)
    for _ in range(2):  # warm through a step and reset cycle
        ctrl.step(to_card(x))
        ctrl.reset()
    sync = (torch.cuda.synchronize if ctrl.device.type == "cuda"
            else lambda: None)
    sync()
    copy_s, ctrl_s, plant_s = (np.zeros(steps) for _ in range(3))
    xs = np.zeros((steps,) + x.shape)
    t_wall = time.perf_counter()
    for k in range(steps):
        if on_period is not None:
            on_period(k)
        t0 = time.perf_counter()
        x_card = to_card(x)
        t1 = time.perf_counter()
        u = ctrl.step(x_card).detach().cpu().double().numpy()  # waits for u
        t2 = time.perf_counter()
        theta = system.theta1 if k > cfg.switch_step else system.theta0
        x = plant(x, u, theta)
        t3 = time.perf_counter()
        copy_s[k], ctrl_s[k], plant_s[k] = t1 - t0, t2 - t1, t3 - t2
        xs[k] = x
    return dict(wall_s=time.perf_counter() - t_wall, copy_s=copy_s,
                ctrl_s=ctrl_s, plant_s=plant_s, xs=xs, system=system)


def report(cfg, run: dict, preset: str, fleet: int = 0) -> dict:
    """The JSON record of :func:`serve`: ``latency_ms`` is the copy of x
    to the device, the step and the read of u (as the JAX package's tool
    times it); ``period_ms`` adds the host plant step; ``plant_share`` is
    the plant step's share of the summed periods."""
    steps = run["xs"].shape[0]
    lat = run["copy_s"] + run["ctrl_s"]
    period = lat + run["plant_s"]
    y_idx = cfg.mpc.cy_index if cfg.mpc.cy_index is not None else 0
    target = float(cfg.reference_value)
    xs = run["xs"]
    tail = xs[-max(steps // 10, 20):, ..., y_idx]
    out = {
        "metric": (f"HIL fleet loop ({preset}, {fleet} plants, native C++ "
                   "batch step)" if fleet else
                   f"HIL serving loop ({preset}, native C++ plant)"),
        "steps": steps,
        "latency_ms": {**_percentiles(lat), "max": float(lat.max()) * 1e3},
        "period_ms": _percentiles(period),
        "plant_ms_p50": float(np.percentile(run["plant_s"], 50)) * 1e3,
        "copy_ms_p50": float(np.percentile(run["copy_s"], 50)) * 1e3,
        "plant_share": float(run["plant_s"].sum() / period.sum()),
        "realtime_budget_ms": cfg.data.h * 1e3,
        "loop_rate_hz": steps / run["wall_s"],
    }
    if fleet:
        sse = np.abs(tail.mean(axis=0) - target)
        out["per_plant_us_p50"] = float(np.percentile(lat, 50)) / fleet * 1e6
        out["tracking"] = {
            "finite": bool(np.isfinite(xs).all()),
            "worst_plant_steady_state_error": float(sse.max()),
            "median_plant_steady_state_error": float(np.median(sse)),
            "target": target,
        }
    else:
        out["tracking"] = {
            "finite": bool(np.isfinite(xs).all()),
            "tail_mean": float(tail.mean()),
            "target": target,
            "steady_state_error": float(abs(tail.mean() - target)),
        }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="pendulum")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain route)")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve a fleet of B plants with BatchedController "
                         "and the native batched plant step")
    args = ap.parse_args(argv)
    cfg, pipe = build(args.preset, args.steps, args.cpu, args.dtype)
    out = report(cfg, serve(cfg, pipe, args.steps, args.fleet), args.preset,
                 args.fleet)
    out["device"] = str(pipe.device)
    if pipe.device.type == "cuda":
        from koopmanx_torch.device import card_line

        out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
