#!/usr/bin/env python3
"""Build the terminal-synthesis kernel, check it and time it on one GPU.

    python3 tools/check_dare_terminal.py [--widths 10,8,3,16,32,1] [--out FILE]

Builds ``koopmanx_torch/csrc/dare_terminal.cu`` once for each width nz
(printing ptxas's register and spill report) and holds the kernel
(``ops/dare_terminal.py::dare_terminal``) against its plain version (the
plain route of ``control/terminal.py::synthesize_terminal``) on random
stabilizable models, at each width on 97 scenarios and at the
``revise2.sweep-64k`` cell's shape (B = 65,536, nz = 10, m = 1, 30
doubling steps), in float64 and float32 (TF32 off): the same scenarios
non-finite, and each scenario's P, K and gamma within ``RTOL`` of its
largest |entry| or, in float32, ten times the plain version's own change
when A moves by one ulp (up, then down), where that is larger; K also
within ten times its m x m inverse's own round-off (``spd_inverse``
forms 1 - (d - 1)(1 / d) for d = R + B'PB, a relative error of about
eps d), and held only to its finiteness where eps d >= 0.1 (there K has
no correct digit in either version: random models whose float32
doubling runs away from the float64 one reach that). Then it
times, in float32 at the cell's shape and at
``tools/bench_terminal_torch.py``'s 512: the kernel (CUDA events over 20
launches), the plain synthesis and the library's (the plain synthesis
with ``torch.linalg``'s routines in its Gauss-Jordan call sites, as
``USE_LAPACK=1`` binds them; a yardstick only), each beside
``benchmark/roofline.py::terminal_work``'s bound, with the kernel's
launch shape from its occupancy query. The last line is all of it as
JSON, with the card's name and power limit; it exits 1 where a check
fails. ``chip_smoke.py`` phase 2 drives :func:`build`, :func:`check` and
:func:`timing` the same way.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# kernel vs plain version, of each scenario's largest |entry|. Both run
# the same arithmetic; the matrix products sum in other orders (the
# kernel's FMAs in index order, cuBLAS's own), and the DARE amplifies that
# round-off (PERF.md, section 2): float32 is held to the larger of 1e-5
# and ten times the plain version's change from one ulp of A
RTOL = {"float64": 1e-9, "float32": 1e-5}
CELL = {"batch": 65536, "nz": 10, "m": 1, "iters": 30}


def random_models(batch, nz, m, seed, dtype, device):
    """``batch`` random stabilizable (A, B), A of spectral radius 0.6-1.2,
    with Q = 10 I and R = 0.01 I shared by the batch."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, nz, nz))
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    a *= rng.uniform(0.6, 1.2, size=(batch, 1, 1)) / radius[:, None, None]
    b = rng.normal(size=(batch, nz, m))
    as_t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    return (as_t(a), as_t(b), as_t(10.0 * np.eye(nz)), as_t(0.01 * np.eye(m)))


def plain(a, b, q, r, iters=CELL["iters"]):
    """(P, K, gamma) by ``synthesize_terminal``'s plain route."""
    from koopmanx_torch.control.terminal import synthesize_terminal
    from koopmanx_torch.types import LinearModel

    c = a.new_zeros(a.shape[:-2] + (1, a.shape[-1]))
    return tuple(synthesize_terminal(LinearModel(a, b, c), q, r, iters))


def event_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build(widths):
    """Build the kernel's library for each width; ``{nz: ptxas's register,
    spill, error and warning lines}`` (empty where it was built before)."""
    from koopmanx_torch.ops import build as builder

    report = {}
    for nz in widths:
        log = builder.build_all(["dare_terminal"], {"KX_DARE_NZ": nz}).get(
            "dare_terminal", "")
        report[nz] = [ln.strip() for ln in log.splitlines()
                      if any(k in ln.lower() for k in (
                          "registers", "spill", "error", "warning"))]
    return report


def check(device, nz, m, batch, dtype, seed):
    """The kernel against the plain version on ``random_models``: a row
    with, for P, K and gamma, the worst relative error and the worst ratio
    to the bound, the scenarios whose finiteness differs, and ``held``."""
    import torch
    from koopmanx_torch.ops.dare_terminal import dare_terminal

    name = str(dtype).replace("torch.", "")
    ins = random_models(batch, nz, m, seed, dtype, device)
    got, ref = dare_terminal(*ins), plain(*ins)
    nudged = []
    if dtype == torch.float32:
        a = ins[0]
        nudged = [plain(torch.nextafter(a, torch.full_like(a, t)), *ins[1:])
                  for t in (float("inf"), -float("inf"))]
    # eps d of the gain's m x m inverse, d = R + B'PB from the plain P
    b64, r64 = ins[1].double(), ins[3].double()
    d = (r64 + b64.transpose(-1, -2) @ ref[0].double() @ b64)
    eps_d = torch.finfo(dtype).eps * d.diagonal(dim1=-2, dim2=-1).abs(
        ).amax(-1)
    row = {"nz": nz, "m": m, "batch": batch, "dtype": name,
           "rtol": RTOL[name], "worst_rel": [], "worst_ratio_to_bound": [],
           "finite_differs": [], "ref_not_finite": [],
           "k_without_digits": int((eps_d >= 0.1).sum())}
    for i, (g, rr) in enumerate(zip(got, ref)):
        flat = lambda t: t.reshape(batch, -1).double()
        g, rr = flat(g), flat(rr)
        bad = ~torch.isfinite(rr).all(-1)
        row["ref_not_finite"].append(int(bad.sum()))
        row["finite_differs"].append(
            int((bad != ~torch.isfinite(g).all(-1)).sum()))
        if i == 1:  # K: no digit to compare where eps d >= 0.1
            bad = bad | (torch.nan_to_num(eps_d, nan=1.0) >= 0.1)
        amax = lambda t: t[~bad].abs().amax(-1)
        scale = amax(rr)
        bound = RTOL[name] * scale
        if i == 1:
            bound = torch.maximum(bound, 10.0 * eps_d[~bad] * scale)
        if nudged:
            floor = torch.stack([amax(flat(v[i]) - rr) for v in nudged])
            floor = torch.nan_to_num(floor.amax(0), nan=float("inf"))
            bound = torch.maximum(bound, 10.0 * floor)
        diff = amax(g - rr)
        row["worst_rel"].append(float((diff / scale.clamp_min(1e-300)).max()))
        row["worst_ratio_to_bound"].append(
            float((diff / bound.clamp_min(1e-300)).max()))
    row["held"] = (not any(row["finite_differs"])
                   and all(v <= 1.0 for v in row["worst_ratio_to_bound"]))
    return row


def timing(device, batch, nz=CELL["nz"], m=CELL["m"], iters=CELL["iters"]):
    """Device ms of the kernel, the plain synthesis and the library's, in
    float32 at ``batch`` x nz x m, beside the bound and the launch shape."""
    import torch
    from benchmark.roofline import least_seconds, terminal_work
    from koopmanx_torch.ops import dare_terminal as dt
    from tools.bench_terminal_torch import library_routines

    ins = random_models(batch, nz, m, 7, torch.float32, device)
    kern = event_ms(lambda: dt.dare_terminal(*ins, iters=iters), 20)
    plain_ms = event_ms(lambda: plain(*ins, iters=iters), 3, warm=1)
    with library_routines():
        lib = event_ms(lambda: plain(*ins, iters=iters), 3, warm=1)
    flops, nbytes = terminal_work(batch, nz, m, iters)
    bound = least_seconds(flops, nbytes) * 1e3
    return {"batch": batch, "nz": nz, "m": m, "iters": iters,
            "kernel_ms": kern, "plain_ms": plain_ms, "library_ms": lib,
            "bound_ms": bound, "roofline_pct": 100.0 * bound / kern,
            "launch_shape": dt.launch_shape(torch.float32, batch,
                                            nz)._asdict()}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="10,8,3,16,32,1")
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_dare_terminal: no CUDA device", file=sys.stderr)
        return 2
    from koopmanx_torch.device import card_line, resolve_device

    dev = resolve_device(None)  # TF32 off
    widths = [int(w) for w in args.widths.split(",")]
    report = {"card": card_line(), "ptxas": build(widths), "checks": [],
              "timing": []}
    for nz, lines in report["ptxas"].items():
        for ln in lines:
            print(f"nvcc nz={nz}: {ln}", flush=True)
    shapes = [(nz, 2 if nz == 3 else 1, 97) for nz in widths]
    shapes.append((CELL["nz"], CELL["m"], CELL["batch"]))
    for nz, m, batch in shapes:
        for dtype in (torch.float64, torch.float32):
            row = check(dev, nz, m, batch, dtype, seed=nz)
            report["checks"].append(row)
            print("check " + json.dumps(row), flush=True)
    for batch in (CELL["batch"], 512):
        row = timing(dev, batch)
        report["timing"].append(row)
        print("timing " + json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0 if all(row["held"] for row in report["checks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
