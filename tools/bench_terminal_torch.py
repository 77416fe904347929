#!/usr/bin/env python
"""Bench the per-step terminal-synthesis (Revise_2 production) workload
with the PyTorch port (counterpart of ``tools/bench_terminal.py``): the
Duffing closed loop with its DARE terminal certificate re-synthesized
every control step, batched scenarios, one card.

The config is the JAX tool's (``tools/bench_terminal.py:41-53``):
``duffing_nn_preset`` in float32, 50 x 50 training data, the MLP lift with
nlift 8, ``terminal_synthesis=True`` with ``terminal_mode='dare'``, the
plant switch at steps // 2, scenarios from ``sample_scenarios`` at
``param_scale=0.15`` (seed 0); on the card the box QP runs the box-ADMM
kernel and the synthesis the terminal-synthesis kernel
(``ops/dare_terminal.py``), one launch each a step. One warm-up run, then
the best of 3 runs, each between two device synchronizations.

``USE_LAPACK=1`` is the library A/B: the hand-written Gauss-Jordan
routines of ``ops/linalg.py`` (``spd_inverse``, ``gj_inverse``,
``gj_solve``) and the names ``control/dare.py`` and ``control/qp.py``
imported from it are rebound to ``torch.linalg.inv`` and
``torch.linalg.solve``: the call sites the JAX tool rebinds
(``tools/bench_terminal.py:20-34``), no more and no less. The engine's
KKT inverse (``engine/core.py``) keeps its own binding in both tools.
Those are the plain route's names: on the kernel route the synthesis
runs the terminal-synthesis kernel in both variants, so the A/B of the
library against the Gauss-Jordan routines is made on the plain route
(``BENCH_QP_BACKEND=xla`` on the card, or the CPU).

Knobs (environment): ``BENCH_BATCH`` (512), ``BENCH_STEPS`` (30),
``USE_LAPACK`` (0), ``BENCH_QP_BACKEND`` (the device's route: ``pallas``
on the card, ``xla`` on the CPU), ``BENCH_DEVICE=cpu`` for the CPU. It
runs on the card otherwise and raises without one. One JSON line, the
JAX tool's keys plus the card's name and power limit, the box-ADMM and
terminal-synthesis kernels' launches over the timed runs and the steps
they ran. It imports no JAX.

  BENCH_BATCH=512 BENCH_STEPS=30 python tools/bench_terminal_torch.py
  BENCH_QP_BACKEND=xla USE_LAPACK=1 python tools/bench_terminal_torch.py
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# (module, name) of every binding the library A/B replaces
LAPACK_SITES = (
    ("koopmanx_torch.ops.linalg", "spd_inverse"),
    ("koopmanx_torch.ops.linalg", "gj_inverse"),
    ("koopmanx_torch.ops.linalg", "gj_solve"),
    ("koopmanx_torch.control.dare", "spd_inverse"),
    ("koopmanx_torch.control.dare", "gj_solve"),
    ("koopmanx_torch.control.qp", "spd_inverse"),
)
TIMED_RUNS = 3


def library_spd_inverse(k, block: int = 1, eps: float = 0.0):
    """``ops.linalg.spd_inverse``'s signature on ``torch.linalg.inv`` (the
    JAX tool's ``jnp.linalg.inv`` of ``k + eps I``; ``block`` unused).
    On the card the library returns its batch of inverses column-major;
    the box-ADMM kernel reads row-major rows, so the result is made
    contiguous (one copy, part of this variant's cost)."""
    if eps:
        k = k + eps * torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    return torch.linalg.inv(k).contiguous()


LIBRARY = {"spd_inverse": library_spd_inverse,
           "gj_inverse": torch.linalg.inv,
           "gj_solve": torch.linalg.solve}


@contextlib.contextmanager
def library_routines():
    """:data:`LAPACK_SITES` bound to the library's routines inside the
    block, and back to their own on the way out."""
    saved = [(importlib.import_module(mod), name) for mod, name in
             LAPACK_SITES]
    old = [getattr(mod, name) for mod, name in saved]
    try:
        for mod, name in saved:
            setattr(mod, name, LIBRARY[name])
        yield
    finally:
        for (mod, name), fn in zip(saved, old):
            setattr(mod, name, fn)


def config(steps: int, device, backend: str = None):
    """The JAX tool's config on ``backend``, by default ``device``'s
    route."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.device import default_qp_backend

    cfg = C.duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.switch_step = steps // 2
    cfg.data = C.DataConfig(n_step=50, n_traj=50)
    cfg.lift = C.LiftConfig(kind="mlp", nlift=8)
    cfg.mpc.terminal_synthesis = True
    cfg.mpc.terminal_mode = "dare"
    cfg.mpc.qp_backend = backend or default_qp_backend(device)
    return cfg


def scenarios(batch: int, device, dtype=torch.float32):
    """The JAX tool's scenarios: seed 0, ``param_scale=0.15``."""
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.systems.library import get_system

    return sample_scenarios(get_system("duffing"),
                            torch.Generator().manual_seed(0), batch,
                            param_scale=0.15, dtype=dtype, device=device)


def run_bench(env) -> dict:
    from koopmanx_torch.device import card_line, resolve_device
    from koopmanx_torch.ops.box_admm import box_admm
    from koopmanx_torch.ops.dare_terminal import dare_terminal
    from koopmanx_torch.run import build_pipeline, run_scenarios

    batch = int(env.get("BENCH_BATCH", "512"))
    steps = int(env.get("BENCH_STEPS", "30"))
    lapack = env.get("USE_LAPACK", "0") == "1"
    device = resolve_device("cpu" if env.get("BENCH_DEVICE") == "cpu"
                            else None)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    with library_routines() if lapack else contextlib.nullcontext():
        pipe = build_pipeline(config(steps, device,
                                     env.get("BENCH_QP_BACKEND")),
                              device=device)
        sc = scenarios(batch, device)
        _, log = run_scenarios(pipe, sc)
        if not bool(torch.isfinite(log.x).all()):
            raise RuntimeError("non-finite trajectory")
        best, before = float("inf"), box_admm.launches
        before_dare = dare_terminal.launches
        for _ in range(TIMED_RUNS):
            log = None
            sync()
            t0 = time.perf_counter()
            _, log = run_scenarios(pipe, sc)
            sync()
            best = min(best, time.perf_counter() - t0)
        launches = box_admm.launches - before
        dare_launches = dare_terminal.launches - before_dare
    return {
        "workload": "duffing + per-step DARE terminal synthesis",
        "lapack": lapack,
        "batch": batch,
        "solves_per_s": round(batch * steps / best, 1),
        "per_step_ms": round(best / steps * 1e3, 3),
        "steps": steps,
        "qp_backend": pipe.config.mpc.qp_backend,
        "box_admm_launches": launches,
        "dare_terminal_launches": dare_launches,
        "steps_run": TIMED_RUNS * steps,
        "finite": bool(torch.isfinite(log.x).all()),
        "card": card_line() if device.type == "cuda" else None,
    }


def main(env=None) -> dict:
    """Run the bench on ``env`` (default ``os.environ``); print and
    return its JSON line."""
    out = run_bench(os.environ if env is None else env)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
