#!/usr/bin/env python3
"""Build the box-ADMM kernel, check it and time it on one GPU.

    python3 tools/check_box_admm.py

Builds ``koopmanx_torch/csrc/box_admm.cu``, prints ptxas's register
report, and runs ``chip_smoke.py``'s phase 2 for this kernel: the kernel
against its plain version at the main path's width and at every compiled
instance's, then its time at the main path's shape (B = 8192, nx = 20,
60 iterations, float32). The last line is the kernels-line entry as JSON,
with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_box_admm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from koopmanx_torch.ops import build

    log = build.build_all(["box_admm"]).get("box_admm", "")
    for line in log.splitlines():
        if any(k in line.lower() for k in ("compiling entry", "registers",
                                            "spill", "error")):
            print(f"nvcc box_admm: {line.strip()}", flush=True)
    entry = cs.phase_kernel_checks(torch.device("cuda"),
                                   cs.ptxas_registers(log))
    print(json.dumps({**entry, "card": cs.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
