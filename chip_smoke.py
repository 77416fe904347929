#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (koopmanx_torch) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (nvcc); it exits non-zero without them,
or without the rest of the repository beside it. Phases, each of which
fails the run on error:

1. build every kernel from ``koopmanx_torch/csrc`` (one nvcc per source,
   all started together) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (float32, B=8192 and a ragged B=1000, float64), and
   time both;
3. drive the slice's main path through the user entry points: the
   flagship batched Duffing closed loop (8192 scenarios x 200 steps, f32,
   horizon 20, plant switch at step 100, qp_backend='pallas'), with the
   kernel launch counts zeroed just before and read just after;
4. run the same loop through the plain route (qp_backend='xla') and hold
   the two against each other: the first 16 steps tightly in float64, then
   the batch-mean control quality of the float32 200-step runs. Beside the
   gate it measures the float32 round-off floor: the plain route against
   itself with x0 nudged by one ulp (the scratch-RLS warm-up amplifies
   such a difference to O(0.1) within 16 steps, which is why the tight
   early gate runs in float64);
5. time both loops once more, warm, with CUDA events.

Prints the kernels JSON line, a slice timing JSON line, the card line
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``) and, as
the last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH, STEPS, HORIZON = 8192, 200, 20
ITERS, SIGMA, ALPHA = 60, 1e-6, 1.6
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor-core FMA rates the kernel's scalar arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# kernel vs plain, max |diff| over xt, z, y, relative to max(1, |ref|):
# both run the same iteration; only the order of the nx-term dot products
# (sequential FMAs in the kernel, cuBLAS's reduction in the plain version)
# differs, a few ulps per iteration through 60 contracting iterations
TOL = {"float32": 1e-5, "float64": 1e-12}
# plain vs kernel closed loop, identical but for that reassociation. During
# the scratch-RLS warm-up the loop amplifies a round-off seed by many orders
# of magnitude (tests/test_kkt_refine.py:53-59 documents it for the JAX
# package), so the tight early gate runs in float64, where the seed is
# ~1e-16; the float32 runs are held to batch-mean control quality, as in
# that test. Phase 4 prints the float32 floor (one ulp of x0) beside it.
LOOP_EARLY_STEPS, LOOP_EARLY_TOL = 16, 1e-4
QUALITY_RTOL = {"tracking MSE": 1e-2, "steady-state error": 5e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def box_inputs(batch: int, nx: int, dtype, device, seed: int):
    """SPD box QPs built like tests/test_pallas.py:74-84, with the KKT
    inverse and rho the solver computes (block-8 elimination)."""
    import torch
    from koopmanx_torch.control.qp import ADMMConfig, _effective_rho, box_kkt
    from koopmanx_torch.ops.linalg import spd_inverse

    g = torch.Generator().manual_seed(seed)
    mm = 0.3 * torch.randn((batch, nx, nx), generator=g, dtype=torch.float64)
    p = mm @ mm.transpose(-1, -2) + 0.5 * torch.eye(nx, dtype=torch.float64)
    q = torch.randn((batch, nx), generator=g, dtype=torch.float64)
    x0 = 0.1 * torch.randn((batch, nx), generator=g, dtype=torch.float64)
    p, q, x0 = (t.to(device=device, dtype=dtype) for t in (p, q, x0))
    cfg = ADMMConfig(iters=ITERS, rho=0.1, kkt_block=8)
    rho = _effective_rho(p, cfg)
    minv = spd_inverse(box_kkt(p, cfg), block=8)
    lo = torch.full_like(q, -1.5)
    return (minv.contiguous(), q, lo, -lo, x0, torch.zeros_like(q), rho)


def box_admm_bound_ms(batch: int, nx: int, iters: int, dtype: str):
    """Least time for the same work on an H100 SXM: bytes (each input read
    once, each output written once) over HBM rate vs operations over the
    dtype's peak."""
    item = 4 if dtype == "float32" else 8
    nbytes = batch * (nx * nx + 6 * nx + 1 + 3 * nx) * item
    flops = batch * iters * (2 * nx * nx + 12 * nx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_checks(device):
    """Kernel vs plain version on the card; returns the kernels-line entry
    for the main path's shape and every case checked."""
    import torch
    from koopmanx_torch.ops.box_admm import box_admm, box_admm_reference

    cases = []
    main = None
    for dtype, batch in ((torch.float32, BATCH), (torch.float32, 1000),
                         (torch.float64, 1000)):
        name = str(dtype).replace("torch.", "")
        args = box_inputs(batch, HORIZON, dtype, device, seed=batch)
        kw = dict(iters=ITERS, sigma=SIGMA, alpha=ALPHA)
        out = box_admm(*args, **kw)
        ref = box_admm_reference(*args, **kw)
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        scale = max(1.0, max(float(r.abs().max()) for r in ref))
        finite = all(bool(torch.isfinite(o).all()) for o in out)
        case = {"dtype": name, "batch": batch, "nx": HORIZON, "iters": ITERS,
                "max_abs_err": err, "tol": TOL[name] * scale}
        cases.append(case)
        print(f"kernel box_admm {name} B={batch}: max|kernel-plain| = {err:.3e}"
              f" (tol {case['tol']:.1e})", flush=True)
        if not finite or not err <= case["tol"]:
            fail(f"box_admm disagrees with its plain version: {case}")
        if main is None:  # float32 at the main path's shape
            ms = cuda_ms(lambda: box_admm(*args, **kw), reps=50)
            plain_ms = cuda_ms(lambda: box_admm_reference(*args, **kw), reps=5)
            bound, bound_by = box_admm_bound_ms(batch, HORIZON, ITERS, name)
            main = {
                "name": "box_admm",
                "route": "cuda",
                "source": "koopmanx_torch/csrc/box_admm.cu",
                "replaces": "koopmanx/ops/qp_pallas_box.py:131 (box_admm_pallas;"
                            " pallas_call at :188)",
                "launches": None,
                "max_abs_err": err,
                "tol": case["tol"],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes it
                "shape": {"batch": batch, "nx": HORIZON, "iters": ITERS,
                          "dtype": name},
            }
    main["checks"] = cases
    return main


def quality(log, tail: int = 50):
    """Batch-mean tracking MSE and steady-state error of x1 against r1."""
    err = log.x[..., 0] - log.r[..., 0]
    mse = float((err ** 2).mean())
    sse = float(err[:, -tail:].abs().mean())
    return mse, sse


def run_loop(backend: str, device, steps: int = STEPS, dtype: str = "float32",
             nudge: bool = False):
    """The flagship loop as a thunk; ``nudge`` moves every x0 up by one
    ulp (the round-off floor of the comparison)."""
    import torch
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    cfg = flagship_config(steps=steps, horizon=HORIZON, qp_backend=backend)
    cfg.dtype = dtype
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), BATCH,
                          param_scale=0.15, dtype=getattr(torch, dtype),
                          device=device)
    if nudge:
        sc = sc._replace(x0=torch.nextafter(sc.x0, torch.full_like(sc.x0, 9.0)))
    return lambda: run_scenarios(pipe, sc)


def timed(fn):
    """``(fn(), seconds)``, timed by CUDA events around the call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def check_loop(carry, log, name: str, steps: int = STEPS):
    import torch

    for label, t in (("x", log.x), ("u", log.u), ("final x", carry.x)):
        if not bool(torch.isfinite(t).all()):
            fail(f"{name} loop: non-finite {label}")
    u_max = float(log.u.abs().max())
    if u_max > 2.0:
        fail(f"{name} loop: |u| = {u_max} > 2")
    if tuple(log.x.shape) != (BATCH, steps, 2):
        fail(f"{name} loop: log.x shape {tuple(log.x.shape)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "koopmanx_torch")):
        print("chip_smoke: koopmanx_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from koopmanx_torch.device import resolve_device
    from koopmanx_torch.ops import build
    from koopmanx_torch.ops.box_admm import box_admm

    device = resolve_device(None)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- 1. build ----
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"nvcc {name}: {line.strip()}", flush=True)
    print(f"phase 1 build: {sorted(reports)} in {build_s:.1f} s", flush=True)
    card = card_line()

    # ---- 2. kernels vs plain versions ----
    entry = phase_kernel_checks(device)

    # ---- 3. the main path through the kernel ----
    run_kernel = run_loop("pallas", device)
    box_admm.launches = 0
    (carry_k, log_k), cold_k = timed(run_kernel)
    launches = box_admm.launches
    entry["launches"] = launches
    print(f"phase 3 main path (pallas): {cold_k:.2f} s cold, box_admm "
          f"launches {launches}", flush=True)
    if launches != STEPS:
        fail(f"box_admm launched {launches} times in {STEPS} steps")
    check_loop(carry_k, log_k, "pallas")

    # ---- 4. the plain route, and the gate between the two ----
    run_plain = run_loop("xla", device)
    box_admm.launches = 0
    (carry_p, log_p), cold_p = timed(run_plain)
    if box_admm.launches != 0:
        fail("the plain route launched the kernel")
    check_loop(carry_p, log_p, "xla")
    early = {}
    for backend in ("pallas", "xla"):
        carry, log = run_loop(backend, device, LOOP_EARLY_STEPS, "float64")()
        check_loop(carry, log, f"{backend} float64", LOOP_EARLY_STEPS)
        early[backend] = log.x
    dx64 = float((early["pallas"] - early["xla"]).abs().max())
    _, log_n = run_loop("xla", device, nudge=True)()  # the float32 floor
    early_dx = lambda a, b: (a.x[:, :LOOP_EARLY_STEPS]
                             - b.x[:, :LOOP_EARLY_STEPS]).abs().amax((1, 2))
    dx32, dx_floor = early_dx(log_k, log_p), early_dx(log_n, log_p)
    (mse_k, sse_k), (mse_p, sse_p) = quality(log_k), quality(log_p)
    mse_n, sse_n = quality(log_n)
    gate = {"dx_first16_f64": dx64, "dx_first16_f64_tol": LOOP_EARLY_TOL,
            "dx_first16_f32": float(dx32.max()),
            "share_within_1e-4_f32": float((dx32 <= 1e-4).float().mean()),
            "dx_all_steps_f32": float((log_k.x - log_p.x).abs().max()),
            "mse_kernel": mse_k, "mse_plain": mse_p,
            "sse_kernel": sse_k, "sse_plain": sse_p,
            "quality_rtol": QUALITY_RTOL,
            "floor_one_ulp_x0_f32": {
                "dx_first16": float(dx_floor.max()),
                "share_within_1e-4": float((dx_floor <= 1e-4).float().mean()),
                "mse": mse_n, "sse": sse_n}}
    print("phase 4 gate " + json.dumps(gate), flush=True)
    if not dx64 <= LOOP_EARLY_TOL:
        fail(f"float64 kernel and plain loops differ by {dx64} in the first "
             f"{LOOP_EARLY_STEPS} steps")
    for a, b, what in ((mse_k, mse_p, "tracking MSE"),
                       (sse_k, sse_p, "steady-state error")):
        if not abs(a - b) <= QUALITY_RTOL[what] * max(abs(b), 1e-9):
            fail(f"{what}: kernel {a} vs plain {b}")

    # ---- 5. warm timing, in turns: plain, kernel, kernel, plain ----
    walls = {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel, run_kernel, run_plain):
        walls[fn].append(timed(fn)[1])
    wall_k = sum(walls[run_kernel]) / 2
    wall_p = sum(walls[run_plain]) / 2
    solves = BATCH * STEPS
    slice_line = {
        "slice": "duffing flagship loop, koopmanx_torch",
        "batch": BATCH, "steps": STEPS, "horizon": HORIZON,
        "dtype": "float32",
        "kernel_route": {"wall_s": wall_k, "runs_s": walls[run_kernel],
                         "solves_per_s": solves / wall_k,
                         "ms_per_step": wall_k / STEPS * 1e3,
                         "box_admm_share": entry["ms"] * STEPS / (wall_k * 1e3),
                         "cold_wall_s": cold_k},
        "plain_route": {"wall_s": wall_p, "runs_s": walls[run_plain],
                        "solves_per_s": solves / wall_p,
                        "ms_per_step": wall_p / STEPS * 1e3,
                        "cold_wall_s": cold_p},
        "build_s": build_s,
        "card": card,
    }
    print(json.dumps(slice_line), flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
