"""Headline benchmark of the port: concurrent MPC solves/s on the flagship
workload (counterpart of ``bench.py``).

Workload: batched closed loops of ``BENCH_PRESET`` (default ``duffing``:
the flagship, 8192 scenarios x 200 steps at horizon N = 20, the random-init
MLP lift 2-100-100-100-8, f32, the plant switch at steps/2) through the
whole per-step pipeline: encode, condensed-QP build, the box QP, plant
step, re-encode, estimator update, controller rebuild. One "solve" is one
control step of one scenario. One warm-up run (it builds the box-ADMM
kernel at first use), then the best of ``BENCH_REPS`` timed runs, each
between two ``torch.cuda.synchronize()``.

Run on the card: ``python -m koopmanx_torch.bench`` (or ``python -m
koopmanx_torch.cli bench``); without a card it raises. On the CPU, on
request only: ``BENCH_DEVICE=cpu python -m koopmanx_torch.bench`` (the
CLI's ``--cpu``).

Knobs (environment): bench.py's, with its names and defaults, except
``BENCH_QP_BACKEND``, which defaults to ``'pallas'`` on the card (the
hand-written box-ADMM kernel, one launch a step: the port's main path)
and to ``'xla'`` on the CPU; ``'xla'`` is the plain PyTorch route, which
repeats the kernel's arithmetic in ~800-900 launches a step. ``BENCH_UNROLL``,
``BENCH_QP_UNROLL`` and ``BENCH_PRECISION`` set JAX-only fields, which the
eager port ignores; the line names them. ``BENCH_KKT_REFINE > 0`` on the
kernel route raises the engine's ``ValueError``, as in the JAX package.

Prints ONE JSON line: ``{"metric", "value" (solves/s), "unit", "detail"}``.
There is no ``vs_baseline``: bench.py's is a share of a TPU baseline.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Mapping, Tuple

import torch

from . import configs as C
from .device import (
    DeviceLike,
    card_line,
    default_qp_backend,
    resolve_device,
    torch_dtype,
)
from .engine.scenario import ScenarioBatch, sample_scenarios
from .ops.box_admm import box_admm
from .run import Pipeline, build_pipeline, run_scenarios
from .systems.library import get_system

# the JAX-only knobs and their defaults in bench.py (:56-57, :70-72)
JAX_ONLY = {"BENCH_UNROLL": "8", "BENCH_QP_UNROLL": "10",
            "BENCH_PRECISION": None}

# bench.py:73-93: (knob, UpdateConfig field, type), set where given
_UPDATE_KNOBS = (
    ("BENCH_W_FILTER", "window_filter", int),
    ("BENCH_W_REFIT_EVERY", "window_refit_every", int),
    ("BENCH_W_FILTER_LATE", "window_filter_late", int),
    ("BENCH_W_FILTER_WARMUP", "window_filter_warmup", int),
    ("BENCH_W_CARRY", "window_carry", str),
    ("BENCH_RIDGE", "ridge", float),
    ("BENCH_W_POLISH", "window_polish", int),
    ("BENCH_W_ANCHOR", "window_anchor", int),
    ("BENCH_W_STORE", "window_store", str),
)

REALTIME_BUDGET_MS = 50.0  # the plant's sample period, h = 0.05 s


def _on_cpu(env: Mapping[str, str]) -> bool:
    return env.get("BENCH_DEVICE") == "cpu"


def bench_config(env: Mapping[str, str] = os.environ) -> C.RunConfig:
    """``C.PRESETS[BENCH_PRESET]()`` with bench.py's overrides, in its
    order (``bench.py:47-101``)."""
    get = env.get
    preset = get("BENCH_PRESET", "duffing")
    steps = int(get("BENCH_STEPS", "200"))
    cfg = C.PRESETS[preset]()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.unroll = int(get("BENCH_UNROLL", JAX_ONLY["BENCH_UNROLL"]))
    cfg.mpc.qp_unroll = int(get("BENCH_QP_UNROLL",
                                JAX_ONLY["BENCH_QP_UNROLL"]))
    cfg.mpc.qp_iters = int(get("BENCH_QP_ITERS", str(cfg.mpc.qp_iters)))
    cfg.mpc.qp_backend = get("BENCH_QP_BACKEND", default_qp_backend(
        "cpu" if _on_cpu(env) else None))
    cfg.mpc.qp_kkt_bf16 = bool(int(get("BENCH_KKT_BF16", "0")))
    cfg.mpc.qp_kkt_refine = int(get("BENCH_KKT_REFINE", "0"))
    cfg.mpc.qp_kkt_block = int(get("BENCH_KKT_BLOCK",
                                   str(cfg.mpc.qp_kkt_block)))
    if get("BENCH_KKT_LOWRANK"):
        cfg.mpc.qp_kkt_lowrank = bool(int(env["BENCH_KKT_LOWRANK"]))
    if get("BENCH_APPLIED_BOUNDS"):
        cfg.mpc.applied_bounds = env["BENCH_APPLIED_BOUNDS"]
    cfg.mpc.qp_kkt_reanchor = int(get("BENCH_KKT_REANCHOR", "16"))
    if get("BENCH_PRECISION"):
        cfg.matmul_precision = env["BENCH_PRECISION"]
    for knob, field, cast in _UPDATE_KNOBS:
        if get(knob):
            setattr(cfg.update, field, cast(env[knob]))
    cfg.mpc.horizon = int(get("BENCH_HORIZON", "20"))
    cfg.switch_step = steps // 2
    if preset == "duffing":
        cfg.data = C.DataConfig(n_step=50, n_traj=50)
        cfg.lift = C.LiftConfig(kind="mlp", nlift=8)
    else:
        cfg.data = dataclasses.replace(cfg.data, n_step=50, n_traj=50)
    return cfg


def bench_workload(cfg: C.RunConfig, batch: int, device: DeviceLike = None
                   ) -> Tuple[Pipeline, ScenarioBatch]:
    """The pipeline of ``cfg`` on ``device`` and its ``batch`` scenarios
    (``bench.py:103-109``): x0 ~ U[0, 2]^n for the tanks (their levels are
    non-negative), U[-2, 2]^n otherwise, each plant's parameters within
    15 % of nominal, drawn from seed 0."""
    pipe = build_pipeline(cfg, device=device)
    x0_range = (0.0, 2.0) if cfg.system.startswith("tank") else (-2.0, 2.0)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          x0_range=x0_range, param_scale=0.15,
                          dtype=torch_dtype(cfg.dtype), device=pipe.device)
    return pipe, sc


def time_runs(pipe: Pipeline, sc: ScenarioBatch, reps: int):
    """``reps`` runs of the batched loop, each between two device
    synchronizations: the best wall seconds and the last run's StepLog."""
    sync = (torch.cuda.synchronize if pipe.device.type == "cuda"
            else lambda: None)
    best, log = float("inf"), None
    for _ in range(reps):
        log = None  # the previous run's log is not kept through the next
        sync()
        t0 = time.perf_counter()
        _, log = run_scenarios(pipe, sc)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, log


def tracked_output(cfg: C.RunConfig, x, r):
    """The tracked output and its target over (B, T): channel ``cy_index``
    against r's first channel for the tanks, x1 against the state
    reference under lifted tracking (r in the log is lifted), else x1
    against r1 (``tools/validate_scale.py:75-91``)."""
    if cfg.mpc.cy_index is not None:
        return x[..., cfg.mpc.cy_index], r[..., 0]
    if cfg.mpc.track_lifted:
        return x[..., 0], torch.full_like(x[..., 0], cfg.reference_value)
    return x[..., 0], r[..., 0]


def tracking_quality(cfg: C.RunConfig, log, tail: int = 50):
    """Batch-mean tracking MSE of the tracked output and its steady-state
    error (mean |y - r| over the last ``tail`` steps)."""
    y, r = tracked_output(cfg, log.x, log.r)
    err = (y - r).double()
    tail = min(tail, err.shape[1])
    return float((err ** 2).mean()), float(err[:, -tail:].abs().mean())


def host_cpu() -> str:
    """The host's CPU: ``/proc/cpuinfo``'s model name, vendor, family,
    model, stepping and clock of its first processor (some virtual
    machines name the model "unknown"), and the number of CPUs."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'not read')} ("
            f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')}"
            f" model {info.get('model', '?')} stepping "
            f"{info.get('stepping', '?')}, {info.get('cpu MHz', '?')} MHz, "
            f"{os.cpu_count()} CPUs)")


def run_bench(env: Mapping[str, str] = os.environ) -> dict:
    """The benchmark as bench.py runs it; returns the JSON record."""
    device = resolve_device("cpu" if _on_cpu(env) else None)
    batch = int(env.get("BENCH_BATCH", "8192"))
    reps = int(env.get("BENCH_REPS", "3"))
    cfg = bench_config(env)
    pipe, sc = bench_workload(cfg, batch, device)
    run_scenarios(pipe, sc)  # warm-up: builds the kernel, outside the clock
    before = box_admm.launches
    best, log = time_runs(pipe, sc, reps)
    launches = box_admm.launches - before
    mse, sse = tracking_quality(cfg, log)
    solves = batch * cfg.steps
    preset = env.get("BENCH_PRESET", "duffing")
    return {
        "metric": (f"MPC solves/s/chip ({preset}, N={cfg.mpc.horizon} "
                   f"horizon, online update, batch={batch})"),
        "value": round(solves / best, 1),
        "unit": "solves/s",
        "detail": {
            "batch": batch,
            "steps": cfg.steps,
            "wall_s": best,
            "per_step_latency_ms": best / cfg.steps * 1e3,
            "realtime_budget_ms": REALTIME_BUDGET_MS,
            "reps": reps,
            "preset": preset,
            "qp_backend": cfg.mpc.qp_backend,
            "box_admm_launches": launches,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "card": card_line() if device.type == "cuda" else None,
            "host_cpu": host_cpu(),
            "ignored_jax_knobs": {k: env.get(k, v)
                                  for k, v in JAX_ONLY.items()},
            "tracking_mse": mse,
            "steady_state_error": sse,
        },
    }


def main(env: Mapping[str, str] = None) -> dict:
    """Run the benchmark and print its one JSON line."""
    result = run_bench(os.environ if env is None else env)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
