#!/usr/bin/env python
"""Reference-length closed-loop validation of the PyTorch port on the card
(counterpart of ``tools/validate_scale.py``).

Runs a preset's one scenario (``run.run_single``) at the reference's full
loop length (Tank_System.m: 3000 steps; vanderpol.py's closed loop: 1000;
duffing.py: 10000) with the f32 recipe, and prints the reference's own
summary metrics (tracking MSE, steady-state error, drift, residual) as one
JSON line, with ``tools/validate_scale.py``'s keys (the tank-only and the
Revise_2 Lyapunov keys where they apply), plus the box-ADMM launches of
the run, the route, the card's name and power limit and the JAX-only knob
it ignores.

Usage: PRESET=tank STEPS=3000 python tools/validate_scale_torch.py
Knobs (environment), ``tools/validate_scale.py``'s: ``PRESET`` (default
``tank``; ``revise2`` is ``revise2_duffing``), ``STEPS`` (3000),
``DTYPE``, ``QP_ITERS``, ``W_FILTER``, ``W_REFIT_EVERY``,
``W_FILTER_LATE``, ``W_FILTER_WARMUP``, ``W_CARRY``, ``W_POLISH``,
``W_ANCHOR``, ``RIDGE``, ``W_STORE``, ``KKT_BLOCK``, ``KKT_BF16``,
``APPLIED_BOUNDS``, ``SWITCH``; ``PRECISION`` is read and reported as
ignored (a JAX-only field). Also ``QP_BACKEND`` (``pallas``, the box-ADMM
kernel, on the card; ``xla``, the plain route, with ``CPU=1``). It runs on
the card and raises without one; ``CPU=1`` asks for the CPU. It imports no
JAX.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# tools/validate_scale.py:46-72: (knob, config section, field, type)
KNOBS = (
    ("QP_ITERS", "mpc", "qp_iters", int),
    ("W_FILTER", "update", "window_filter", int),
    ("W_REFIT_EVERY", "update", "window_refit_every", int),
    ("W_FILTER_LATE", "update", "window_filter_late", int),
    ("W_FILTER_WARMUP", "update", "window_filter_warmup", int),
    ("W_CARRY", "update", "window_carry", str),
    ("W_POLISH", "update", "window_polish", int),
    ("W_ANCHOR", "update", "window_anchor", int),
    ("RIDGE", "update", "ridge", float),
    ("W_STORE", "update", "window_store", str),
    ("KKT_BLOCK", "mpc", "qp_kkt_block", int),
    ("KKT_BF16", "mpc", "qp_kkt_bf16", lambda v: bool(int(v))),
    ("APPLIED_BOUNDS", "mpc", "applied_bounds", str),
)


def config(env):
    """The preset with the knobs of ``env``, the route of its device."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.device import default_qp_backend

    preset = env.get("PRESET", "tank")
    cfg = dict(C.PRESETS, revise2=C.revise2_duffing_preset)[preset]()
    cfg.steps = int(env.get("STEPS", "3000"))
    cfg.dtype = env.get("DTYPE", "float32")
    if env.get("PRECISION"):
        cfg.matmul_precision = env["PRECISION"]
    for knob, section, field, cast in KNOBS:
        if env.get(knob):
            setattr(getattr(cfg, section), field, cast(env[knob]))
    if env.get("SWITCH"):
        cfg.switch_step = int(env["SWITCH"])
    cfg.mpc.qp_backend = env.get("QP_BACKEND", default_qp_backend(
        "cpu" if env.get("CPU") else None))
    return preset, cfg


def main(env=None) -> dict:
    from koopmanx_torch.bench import tracked_output
    from koopmanx_torch.device import card_line, resolve_device
    from koopmanx_torch.ops.box_admm import box_admm
    from koopmanx_torch.run import build_pipeline, run_single

    env = os.environ if env is None else env
    device = resolve_device("cpu" if env.get("CPU") else None)
    preset, cfg = config(env)
    steps = cfg.steps
    pipe = build_pipeline(cfg, device=device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    before = box_admm.launches
    sync()
    t0 = time.perf_counter()
    carry, log = run_single(pipe)
    sync()
    wall = time.perf_counter() - t0
    launches = box_admm.launches - before

    host = lambda t: t.detach().cpu().double().numpy()
    x, u = host(log.x), host(log.u)
    # the tracked output and its target (tools/validate_scale.py:75-91)
    y, target = (host(t) for t in tracked_output(cfg, log.x, log.r))
    target = target[-1]
    tail = slice(-max(steps // 10, 20), None)
    out = {
        "preset": preset,
        "steps": steps,
        "dtype": cfg.dtype,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "wall_s": wall,
        "finite": bool(np.isfinite(x).all() and np.isfinite(u).all()),
        "tracking_mse": float(np.mean((y - target) ** 2)),
        "steady_state_error": float(abs(y[tail].mean() - target)),
        "u_abs_max": float(np.abs(u).max()),
        "final_drift_a": float(host(log.drift_a)[-1]),
        "final_residual": float(host(log.residual)[-1]),
        "qp_backend": cfg.mpc.qp_backend,
        "box_admm_launches": launches,
        "card": card_line() if on_card else None,
        "ignored_jax_knobs": {"PRECISION": env.get("PRECISION")},
    }
    if preset.startswith("tank"):
        # the pre-switch transient overshoot and the post-switch tail
        sw = min(cfg.switch_step, steps)
        out["pre_switch_overshoot"] = float(y[:sw].max())
        out["post_switch_tail_mean"] = float(y[tail].mean())
    if cfg.mpc.terminal_synthesis:
        v = host(log.lyapunov)
        out["lyapunov_first"] = float(v[0])
        out["lyapunov_tail_mean"] = float(v[tail].mean())
        # macro decrease: V decays from its transient scale to the tail
        out["lyapunov_decayed"] = bool(v[tail].mean() < 0.05 * v[:20].max())
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
