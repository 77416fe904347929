#!/usr/bin/env python3
"""Where the time of one koopmanx_torch control step goes, on one GPU.

Runs a batched loop (8192 scenarios, f32, horizon 20, the kernel route by
default) for a few warm-up steps, then profiles ``--steps`` more with
``torch.profiler`` (CPU and CUDA activities). ``--config flagship`` is the
flagship Duffing loop (``configs.flagship_config``); ``--config tank`` the
tank bench loop (``configs.tank_bench_config``, x0 ~ U[0, 2]^2), profiled
in both of its regimes: ``warm-up`` (the first ``window_filter_warmup``
steps, which refit the window every step) and ``cadence`` (the steps past
it, which refit one step in ``window_refit_every`` with the late chain;
profiled from step 0 with the warm-up set to 0, over ``--steps`` rounded up
to whole cadence cycles); ``--config rbf128`` the large-lift loop
(``configs.rbf128_bench_config``: nlift 128, the Woodbury lane), whose
stages are the ring write, the Gram motion and Sherman-Morrison updates
inside ``window_update_carry``, the Newton-Schulz polish, the model from
the carried statistics, the finiteness sums, the per-scenario select, the
prediction matrices and the model guard's spectral radius; ``--config
tank_mimo`` the two-pump loop (``configs.tank_mimo_bench_config``: m = 2,
N*m = 40, the window refit every step), profiled on both routes as two
regimes: ``pallas`` (the dense 40 x 40 ``spd_inverse``, then the
box-ADMM kernel at nx = 40) and ``xla`` (the output-space construction
``lowrank_kkt_inverse``, then the plain ADMM), each with the refit's
Schulz chains and the ring write; ``--config vdp`` the Van der Pol
lifted-tracking loop (``configs.vdp_bench_config``: the QP tracks the
lifted reference, py = nlift = 8, so Qbar is (8N, 8N)), whose stages are
the prediction matrices, the condensed QP, the KKT inverse and the
square-root RLS; ``--config vdp_rbf`` the storage-method loop
(``configs.vdp_rbf_bench_config``: two batched pseudo-inverses a step,
``pinv``, inside ``storage_model``); ``--config rls_chol`` the flagship
with the Gram-carry RLS and its reset (``gram_rls_model``: two
``spd_inverse`` with a ridge a step); ``--config revise2_duffing`` and
``--config revise2_vdp`` the Revise_2 loops
(``configs.revise2_duffing_bench_config``, ``revise2_vdp_bench_config``:
the per-step DARE terminal synthesis), whose stages are
``synthesize_terminal`` and the pivoted ``gj_inverse`` inside it, the
monitor block (``revise2_monitors``) and the QP build with the batched
Qbar (``weight_bar``, ``condensed_qp``). For each regime it prints the top
device kernels
by time, then one JSON line: wall ms per step, device-busy ms per step (the
union of the kernels' intervals), the device's idle share, kernel launches
per step, the peak device memory of the unprofiled run, the box-ADMM kernel's share of busy time and device time per
launch, and the device time under each of a few named stages
(``torch.profiler.record_function`` around the engine's functions: for the
tank, the Newton-Schulz chains, the refit, the ring write and the
finiteness checks), and the host synchronizations a step
(``torch.cuda.set_sync_debug_mode('warn')`` over a short unprofiled run,
by the line that caused each). For the tank a last JSON line weights the two regimes
by the steps each takes in the shipped preset's run (``tank_preset``) and
in ``chip_smoke.py``'s phase 7. ``--out`` also writes the whole kernel
tables to a file.

    python3 tools/profile_torch_step.py
        [--config flagship|tank|rbf128|tank_mimo|vdp|vdp_rbf|rls_chol|
                  revise2_duffing|revise2_vdp]
        [--steps 10]
        [--batch 8192] [--out FILE]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--backend", default="pallas")
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "tank", "rbf128", "tank_mimo",
                             "vdp", "vdp_rbf", "rls_chol", "revise2_duffing",
                             "revise2_vdp"))
    ap.add_argument("--out", default=None, help="write the kernel table here")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from koopmanx_torch.configs import (
        flagship_config,
        rbf128_bench_config,
        revise2_duffing_bench_config,
        revise2_vdp_bench_config,
        tank_bench_config,
        tank_mimo_bench_config,
        tank_preset,
        vdp_bench_config,
        vdp_rbf_bench_config,
    )
    from koopmanx_torch.control import qp
    from koopmanx_torch.engine import core
    from koopmanx_torch.engine import loop as engine_loop
    from koopmanx_torch.edmd import rls, windowed
    from koopmanx_torch.ops import linalg
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    stages = {}
    for module, name in ((windowed, "schulz_inverse"), (core, "window_model"),
                         (core, "window_update"), (core, "_tree_finite"),
                         (core, "sqrt_rls_update_ab"),
                         (core, "sqrt_rls_update_c"),
                         (core, "sqrt_rls_model"), (qp, "spd_inverse"),
                         (core, "window_update_carry"),
                         (windowed, "window_update"), (windowed, "_sm_step"),
                         (windowed, "_polished"),
                         (core, "window_model_carry"), (core, "_select"),
                         (core, "prediction_matrices"),
                         (core, "_spectral_radius_estimate"),
                         (core, "lowrank_kkt_inverse"),
                         (core, "condensed_qp"), (core, "storage_update"),
                         (core, "storage_model"), (rls, "pinv"),
                         (core, "gram_rls_update"),
                         (core, "gram_rls_model"),
                         (core, "synthesize_terminal"),
                         (linalg, "gj_inverse"),
                         (engine_loop, "revise2_monitors"),
                         (core, "weight_bar")):
        stages[name] = 0.0

        def ranged(*a, _fn=getattr(module, name), _name=name, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)

        setattr(module, name, ranged)

    def loop(steps, warmup_end, backend):
        if args.config == "tank":
            cfg = tank_bench_config(steps=steps, qp_backend=backend)
            if warmup_end is not None:
                cfg.update.window_filter_warmup = warmup_end
            x0_range = (0.0, 2.0)
        elif args.config == "tank_mimo":
            cfg = tank_mimo_bench_config(steps=steps, qp_backend=backend)
            x0_range = (0.0, 2.0)
        elif args.config == "rbf128":
            cfg = rbf128_bench_config(steps=steps, qp_backend=backend)
            x0_range = (-2.0, 2.0)
        elif args.config in ("revise2_duffing", "revise2_vdp"):
            make = (revise2_duffing_bench_config
                    if args.config == "revise2_duffing"
                    else revise2_vdp_bench_config)
            cfg = make(steps=steps, qp_backend=backend)
            x0_range = (-2.0, 2.0)
        elif args.config in ("vdp", "vdp_rbf"):
            make = (vdp_bench_config if args.config == "vdp"
                    else vdp_rbf_bench_config)
            cfg = make(steps=steps, qp_backend=backend)
            x0_range = (-2.0, 2.0)
        elif args.config == "rls_chol":  # chip_smoke.py phase 14's run
            cfg = flagship_config(steps=steps, horizon=20,
                                  qp_backend=backend)
            cfg.update.mode, cfg.update.ridge = "rls_chol", 1e-2
            cfg.update.reset_mult = 4.0
            x0_range = (-2.0, 2.0)
        else:
            cfg = flagship_config(steps=steps, horizon=20,
                                  qp_backend=backend)
            x0_range = (-2.0, 2.0)
        pipe = build_pipeline(cfg)  # CUDA, or raises
        sc = sample_scenarios(get_system(cfg.system),
                              torch.Generator().manual_seed(0), args.batch,
                              x0_range=x0_range, param_scale=0.15)
        return lambda: run_scenarios(pipe, sc)

    def profile_regime(steps, warmup_end, backend):
        loop(args.warmup, warmup_end, backend)()
        run = loop(steps, warmup_end, backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        # device-side events only (kernels, copies, fills): the aten ops
        # that launched them report the same time again
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("aten::") and e.name not in stages]
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for start, end, name in spans:
            by_name[name][0] += end - start
            by_name[name][1] += 1
        busy_us, reach = 0.0, float("-inf")
        for start, end, _ in sorted(spans):
            if end > reach:
                busy_us += end - max(start, reach)
                reach = end
        rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        lines = [f"{'device us':>12} {'count':>8}  name"]
        lines += [f"{us:12.1f} {n:8d}  {name[:100]}" for name, (us, n) in rows]
        # the host-side ranges, each with the device time of the kernels
        # that the operations inside it launched
        stage_us = dict.fromkeys(stages, 0.0)
        for e in prof.events():
            if e.name in stages and e.device_type == DeviceType.CPU:
                total = getattr(e, "device_time_total", None)
                stage_us[e.name] += e.cuda_time_total if total is None else total
        # host synchronizations, by the source line that caused each
        sync_steps = 3
        run_sync = loop(sync_steps, warmup_end, backend)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_sync()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = collections.Counter(
            f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            # not the mode's one-time notice that it is a prototype
            if "synchroniz" in str(w.message)
            and "prototype" not in str(w.message))
        admm_us = sum(us for name, (us, _) in rows if "box_admm" in name)
        admm_n = sum(n for name, (_, n) in rows if "box_admm" in name)
        return lines, {
            "steps": steps,
            "wall_ms_per_step": wall_plain / steps * 1e3,
            "wall_ms_per_step_profiled": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            # busy time from the profiled run against the unprofiled wall
            "device_idle_share": 1.0 - busy_us / (wall_plain * 1e6),
            "device_ops_per_step": len(spans) / steps,
            "peak_device_gib": peak / 2**30,
            "box_admm_share_of_busy": admm_us / busy_us if busy_us else None,
            "box_admm_us_per_launch": admm_us / admm_n if admm_n else None,
            # device time under each named stage (nested: window_model
            # holds the Schulz chains; window_update_carry holds the ring
            # write, the Sherman-Morrison steps and the polish), per step
            # and as a share of busy time
            "stage_device_ms_per_step": {k: us / steps / 1e3
                                         for k, us in stage_us.items() if us},
            "stage_share_of_busy": {k: us / busy_us for k, us in
                                    stage_us.items() if us and busy_us},
            "host_syncs_per_step": sum(syncs.values()) / sync_steps,
            "host_sync_sources": {k: v / sync_steps
                                  for k, v in syncs.most_common(5)},
        }

    if args.config == "tank":
        every = tank_bench_config().update.window_refit_every
        regimes = {"warm-up": (args.steps, None, args.backend),
                   "cadence": (-(-args.steps // every) * every, 0,
                               args.backend)}
    elif args.config == "tank_mimo":  # one regime a route
        regimes = {b: (args.steps, None, b) for b in ("pallas", "xla")}
    else:
        regimes = {"all": (args.steps, None, args.backend)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    results, tables = {}, []
    for regime, (steps, warmup_end, backend) in regimes.items():
        lines, result = profile_regime(steps, warmup_end, backend)
        results[regime] = result
        tables += [f"# {args.config}, {regime}"] + lines
        print("\n".join(lines[:26]))
        print(json.dumps({"config": args.config, "regime": regime,
                          "backend": backend, "batch": args.batch,
                          **result, "card": card}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(tables) + "\n")
    if args.config == "tank":
        # each run's steps split between the regimes: the shipped preset
        # (3000 steps, 300 of warm-up) and phase 7 (400 steps)
        mixes = {}
        for name, cfg in (("tank_preset", tank_preset()),
                          ("chip_smoke phase 7", tank_bench_config())):
            warm = min(cfg.update.window_filter_warmup, cfg.steps) / cfg.steps
            share = {"warm-up": warm, "cadence": 1.0 - warm}
            mix = {k: sum(share[r] * results[r][k] for r in results)
                   for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                             "device_ops_per_step")}
            busy = {r: results[r]["device_busy_ms_per_step"] * share[r]
                    for r in results}
            stage = lambda k: sum(
                share[r] * results[r]["stage_device_ms_per_step"].get(k, 0.0)
                for r in results)
            admm = sum(share[r] * results[r]["device_busy_ms_per_step"]
                       * (results[r]["box_admm_share_of_busy"] or 0.0)
                       for r in results)
            mixes[name] = {
                "steps": cfg.steps, "warmup_share": warm, **mix,
                "device_idle_share": 1.0 - mix["device_busy_ms_per_step"]
                / mix["wall_ms_per_step"],
                "busy_share_by_regime": {
                    r: v / mix["device_busy_ms_per_step"]
                    for r, v in busy.items()},
                "schulz_share_of_busy": stage("schulz_inverse")
                / mix["device_busy_ms_per_step"],
                "window_model_share_of_busy": stage("window_model")
                / mix["device_busy_ms_per_step"],
                "box_admm_share_of_busy": admm
                / mix["device_busy_ms_per_step"],
            }
        print(json.dumps({"config": "tank", "mix": mixes, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
