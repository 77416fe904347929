#!/usr/bin/env python3
"""Where the time of one koopmanx_torch control step goes, on one GPU.

Runs the flagship batched Duffing loop (8192 scenarios, f32, horizon 20,
the kernel route by default) for a few warm-up steps, then profiles
``--steps`` more with ``torch.profiler`` (CPU and CUDA activities). Prints
the top device kernels by time, then one JSON line: wall ms per step,
device-busy ms per step (the union of the kernels' intervals), the
device's idle share, kernel launches per step, and the box-ADMM kernel's
share of busy time and device time per launch. ``--out`` also writes the
whole kernel table to a file.

    python3 tools/profile_torch_step.py [--steps 10] [--batch 8192] [--out FILE]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--backend", default="pallas")
    ap.add_argument("--out", default=None, help="write the kernel table here")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from koopmanx_torch.configs import flagship_config
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import build_pipeline, run_scenarios
    from koopmanx_torch.systems.library import get_system

    def loop(steps):
        cfg = flagship_config(steps=steps, horizon=20, qp_backend=args.backend)
        pipe = build_pipeline(cfg)  # CUDA, or raises
        sc = sample_scenarios(get_system("duffing"),
                              torch.Generator().manual_seed(0), args.batch,
                              param_scale=0.15)
        return lambda: run_scenarios(pipe, sc)

    loop(args.warmup)()
    run = loop(args.steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side events only (kernels, copies, fills): the aten ops that
    # launched them report the same time again
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith("aten::")]
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
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:26]))
    admm_us = sum(us for name, (us, _) in rows if "box_admm" in name)
    admm_n = sum(n for name, (_, n) in rows if "box_admm" in name)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "backend": args.backend, "batch": args.batch, "steps": args.steps,
        "wall_ms_per_step": wall_plain / args.steps * 1e3,
        "wall_ms_per_step_profiled": wall / args.steps * 1e3,
        "device_busy_ms_per_step": busy_us / args.steps / 1e3,
        # busy time from the profiled run against the unprofiled wall
        "device_idle_share": 1.0 - busy_us / (wall_plain * 1e6),
        "device_ops_per_step": len(spans) / args.steps,
        "box_admm_share_of_busy": admm_us / busy_us if busy_us else None,
        "box_admm_us_per_launch": admm_us / admm_n if admm_n else None,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
