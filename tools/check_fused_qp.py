#!/usr/bin/env python3
"""Build the AoS fused-QP kernel, check it and time it on one GPU.

    python3 tools/check_fused_qp.py [--parent-fused-qp LIB]

Builds ``koopmanx_torch/csrc/fused_qp.cu``, prints ptxas's register, stack
and spill report (and fails on any stack or spill), and runs
``chip_smoke.py``'s phase 2 for this kernel: the kernel against its plain
version at the flagship's shapes (float32 at B = 8192 and 1000, float64 at
1000) and at each edge of its instances, each case with its instance and
occupancy, then its time at B = 8192, float32. It then breaks that time
down by stage: device time with 0 or 16 Newton-Schulz steps and 0 or 60
ADMM iterations (the prologue, QP build, norms and seed run in every
case). With ``--parent-fused-qp`` (another checkout's ``libfused_qp.so``)
it also holds the two kernels against each other, times them in turns and
breaks the parent's time down the same way. The last line is the
kernels-line entry as JSON, with the breakdown and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# (Newton-Schulz steps, ADMM iterations) of the breakdown
STAGES = ((0, 0), (16, 0), (0, 60), (16, 60))


def breakdown(cs, solve):
    """Device ms of ``solve`` on phase 2's float32 B = 8192 inputs at each
    of ``STAGES``."""
    import torch
    from koopmanx_torch.ops import FusedQPConfig

    args, _ = cs.fused_inputs(cs.BATCH, torch.float32, torch.device("cuda"),
                              seed=cs.BATCH)
    out = {}
    for schulz, iters in STAGES:
        cfg = FusedQPConfig(horizon=cs.HORIZON, iters=iters,
                            schulz_iters=schulz)
        out[f"schulz{schulz}_iters{iters}"] = cs.device_ms(
            lambda: solve(*args, cfg), reps=20)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent-fused-qp", metavar="LIB",
                        help="libfused_qp.so of another checkout, held "
                             "against this one's (not gated)")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("check_fused_qp: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from koopmanx_torch.ops import build, fused_qp_solve

    log = build.build_all(["fused_qp"]).get("fused_qp", "")
    for line in log.splitlines():
        if any(k in line.lower() for k in ("compiling entry", "registers",
                                            "spill", "error")):
            print(f"nvcc fused_qp: {line.strip()}", flush=True)
    for kernel, stack, spill_st, spill_ld in cs.ptxas_stack_and_spills(log):
        if stack or spill_st or spill_ld:
            cs.fail(f"ptxas gives {kernel} {stack} bytes of stack, "
                    f"{spill_st}/{spill_ld} bytes of spill stores/loads")
    entries = cs.phase_fused_checks(
        torch.device("cuda"), {"fused_qp": cs.ptxas_registers(log)},
        names=("fused_qp",), parent_lib=opts.parent_fused_qp)
    stages = {"this": breakdown(cs, fused_qp_solve)}
    if opts.parent_fused_qp:
        stages["parent"] = breakdown(cs, cs.parent_fused_qp(opts.parent_fused_qp))
    print("breakdown (device ms, float32, B = 8192) " + json.dumps(stages),
          flush=True)
    print(json.dumps({**entries["fused_qp"], "breakdown_ms": stages,
                      "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
