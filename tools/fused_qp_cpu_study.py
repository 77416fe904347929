#!/usr/bin/env python3
"""What the fused condensed-QP path's plain version computes, on the CPU.

Prints the numbers that say what a GPU run of ``chip_smoke.py`` phase 6
should reproduce, from the plain PyTorch version alone (no kernel, no
card; no JAX):

1. the flagship loop (``flagship_config``, the plain route) at a small
   batch for 200 steps, then on its end state: the fused plain version's
   float32-vs-float64 gap, its first move's gap to the engine's own
   control solve, and the Newton-Schulz residual ||I - K X||_F after 16
   steps;
2. fixture-like QPs (tests/test_pallas.py:18-43, N = 10, cold start) at
   B = 8192: the fused plain version at 24 Newton-Schulz steps and 800
   iterations against the general ``solve_qp``, in float64 and float32,
   and ``solve_qp`` in float32 against itself in float64.

    python3 tools/fused_qp_cpu_study.py [--loop-batch 64]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koopmanx_torch.configs import flagship_config  # noqa: E402
from koopmanx_torch.control import condensed as tc  # noqa: E402
from koopmanx_torch.control.qp import ADMMConfig, solve_qp  # noqa: E402
from koopmanx_torch.engine.core import make_control_solver  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.ops.fused_qp import (  # noqa: E402
    FusedQPConfig,
    fused_qp_reference,
    fused_qp_terms,
    newton_schulz_kkt_inverse,
)
from koopmanx_torch.run import build_pipeline, ref_fn_for, replicate, run_scenarios  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.types import LinearModel, QPData  # noqa: E402


def loop_end_state(batch: int):
    cfg = flagship_config(steps=200, horizon=20, qp_backend="xla")
    pipe = build_pipeline(cfg, device="cpu")
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          param_scale=0.15, dtype=torch.float32, device="cpu")
    carry, _ = run_scenarios(pipe, sc)
    model, mc, ec = carry.model, cfg.mpc, pipe.engine_cfg
    py, m = pipe.params.q_block.shape[0], model.B.shape[-1]
    z = pipe.dictionary(carry.x)
    ref_fn = ref_fn_for(cfg, py, "cpu")
    yr = ref_fn(cfg.steps).reshape(-1).expand(batch, -1)
    fcfg = FusedQPConfig(horizon=mc.horizon, iters=mc.qp_iters, rho=mc.qp_rho,
                         sigma=ec.qp_sigma, alpha=ec.qp_alpha,
                         f_clamp=ec.f_clamp, qdiag=(mc.q_weight,) * py,
                         rdiag=(mc.r_weight,) * m, u_lo=(mc.u_min,) * m,
                         u_hi=(mc.u_max,) * m)
    args = [t.contiguous() for t in (model.A, model.B, model.C, z, yr,
                                     carry.warm_x)]
    u32 = fused_qp_reference(*args, fcfg)
    u64 = fused_qp_reference(*(t.double() for t in args), fcfg)
    dec = make_control_solver(ec, ref_fn, m)(
        replicate(pipe.params, batch), model, z, carry.warm_x, carry.warm_y,
        cfg.steps)
    gap = (u32[:, :m] - dec.u_applied).abs().amax(-1)
    p_mat, _ = fused_qp_terms(*args[:5], fcfg)
    kkt, x_inv, _ = newton_schulz_kkt_inverse(p_mat, fcfg)
    res = torch.linalg.matrix_norm(torch.eye(kkt.shape[-1]) - kkt @ x_inv)
    return {"batch": batch,
            "plain_f32_vs_f64": float((u32.double() - u64).abs().max()),
            "first_move_gap_to_engine": {"max": float(gap.max()),
                                         "median": float(gap.median())},
            "newton_schulz_residual_fro": {"median": float(res.median()),
                                           "max": float(res.max())}}


def fixture_qps(batch: int, horizon: int, seed: int, dtype):
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    a = 0.1 * torch.randn((batch, 8, 8), **f64) + 0.8 * torch.eye(8, dtype=torch.float64)
    b = 0.3 * torch.randn((batch, 8, 1), **f64)
    cyc = 0.5 * torch.randn((batch, 2, 8), **f64)
    z0 = torch.randn((batch, 8), **f64)
    yr = torch.tensor([1.0, 0.0], dtype=torch.float64).repeat(batch, horizon)
    warm = torch.zeros((batch, horizon), dtype=torch.float64)
    return [t.to(dtype) for t in (a, b, cyc, z0, yr, warm)]


def convergence(batch: int, horizon: int = 10):
    out, sols = {}, {}
    for dtype in (torch.float64, torch.float32):
        a, b, cyc, z0, yr, warm = fixture_qps(batch, horizon, 2, dtype)
        cfg = FusedQPConfig(horizon=horizon, iters=800, schulz_iters=24)
        u = fused_qp_reference(a, b, cyc, z0, yr, warm, cfg)
        eye = lambda k: torch.eye(k, dtype=dtype).expand(batch, k, k)
        pred = tc.prediction_matrices(LinearModel(a, b, cyc), horizon)
        lo = torch.full((batch, horizon), -2.0, dtype=dtype)
        box = tc.condensed_qp(pred, z0, yr, tc.weight_bar(100.0 * eye(2), horizon),
                              1e-4 * eye(horizon), lo, -lo)
        x = solve_qp(QPData(box.P, box.q, eye(horizon), box.l, box.u),
                     ADMMConfig(iters=800, rho=0.1)).x
        sols[dtype] = (u.double(), x.double())
    (u64, x64), (u32, x32) = sols[torch.float64], sols[torch.float32]
    far = ((x32 - x64).abs().amax(-1) > 5e-3)
    out = {"batch": batch, "horizon": horizon,
           "fused_f64_vs_solve_qp_f64": float((u64 - x64).abs().max()),
           "fused_f32_vs_solve_qp_f64": float((u32 - x64).abs().max()),
           "fused_f32_vs_fused_f64": float((u32 - u64).abs().max()),
           "solve_qp_f32_vs_f64": float((x32 - x64).abs().max()),
           "solve_qp_f32_qps_off_by_over_5e-3": int(far.sum())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loop-batch", type=int, default=64)
    ap.add_argument("--qp-batch", type=int, default=8192)
    args = ap.parse_args()
    with torch.inference_mode():
        print(json.dumps({"device": "cpu", "torch": torch.__version__,
                          "loop_end_state": loop_end_state(args.loop_batch),
                          "convergence": convergence(args.qp_batch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
