#!/usr/bin/env python3
"""Build the QP-build kernel, check it and time it on one GPU.

    python3 tools/check_qp_build.py [--out FILE]

Builds ``koopmanx_torch/csrc/qp_build.cu`` once for each shape below
(printing ptxas's register and spill report) and holds the kernel
(``ops/qp_build.py::qp_build``) against its plain version
(``ops/qp_build.py::plain``) on random models, at each shape on 97
scenarios and at the two benchmark cells' shapes, in float64 and float32
(TF32 off): the same entries non-finite, and each scenario's P and q
within ``RTOL`` of its largest |entry| or, in float32, ten times the plain
version's own change when A moves by one ulp (up, then down), where that
is larger. Then it times, in float32 at the cells' shapes: the kernel
(CUDA events over 50 launches) and the plain version, beside the bound of
:func:`work` and the kernel's launch shape from its occupancy query:

- ``duffing.sweep-256k``: B = 262,144, nz 8, m 1, py 2, N 10; Q, R and
  yr shared, no terminal block;
- ``revise2.sweep-64k``: B = 65,536, nz 10, m 1, py 2, N 10, with a
  per-scenario terminal block.

The last line is all of it as JSON, with the card's name and power limit;
it exits 1 where a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# kernel vs plain version, of each scenario's largest |entry|: the same
# arithmetic, the products summed in other orders (the kernel's FMAs in
# index order, cuBLAS's own)
RTOL = {"float64": 1e-12, "float32": 1e-5}
# (name, batch, (nz, m, py, N), terminal block)
CELLS = [("duffing.sweep-256k", 262144, (8, 1, 2, 10), False),
         ("revise2.sweep-64k", 65536, (10, 1, 2, 10), True)]
# the caps' edges (nz 32, N m 32, py 32 with N py 128, one state and one
# step), an odd shape, and the tank and lifted-tracking presets' shapes
EDGES = [(32, 1, 2, 10), (8, 1, 2, 32), (8, 2, 4, 16), (4, 4, 32, 4),
         (1, 1, 1, 1), (5, 3, 3, 7), (11, 1, 1, 20), (8, 1, 8, 10)]
F_CLAMP = 1e5


def work(batch, nz, m, py, horizon, terminal, itemsize=4):
    """(operations, bytes) of the build of ``batch`` scenarios: the ladder
    (bit_length(N) - 1 products of nz x nz), the rows g_1..g_N
    (py x nz times nz x nz), the Markov blocks, F1 z, F2' Qbar over Qbar's
    blocks, (F2' Qbar) F2, Qbar err and F2' of it; A, B, CyC, z and the
    terminal block read once, P and q written once (Q, R and yr shared)."""
    nx, np_ = horizon * m, horizon * py
    flops = 2 * ((horizon.bit_length() - 1) * nz ** 3
                 + horizon * py * nz * nz + horizon * py * nz * m
                 + np_ * nz + nx * np_ * py + nx * nx * np_ + np_ * py
                 + nx * np_)
    reads = nz * nz + nz * m + py * nz + nz + (py * py if terminal else 0)
    writes = nx * nx + nx
    return batch * flops, batch * (reads + writes) * itemsize


def random_case(batch, shape, terminal, dtype, device, seed):
    """Random (A, B, CyC, z, yr, Q, R, terminal): A of spectral radius
    0.6-1.2, Q = 10 I and R = 0.1 I and yr shared by the batch, a
    per-scenario symmetric positive definite terminal block where asked."""
    import torch

    nz, m, py, horizon = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    draw = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa: E731
    a = draw(batch, nz, nz)
    radius = torch.linalg.eigvals(a).abs().amax(-1)
    scale = 0.6 + 0.6 * torch.rand(batch, generator=gen, dtype=torch.float64)
    a = a * (scale / radius)[:, None, None]
    term = None
    if terminal:
        x = draw(batch, py, py)
        term = 30.0 * (x @ x.transpose(1, 2) / py + torch.eye(py))
    out = (a, draw(batch, nz, m), draw(batch, py, nz), draw(batch, nz),
           draw(horizon, py), 10.0 * torch.eye(py), 0.1 * torch.eye(m), term)
    return tuple(None if t is None else t.to(device, dtype) for t in out)


def build(shapes):
    """Build the kernel's library for each shape; ``{shape: ptxas's
    register, spill, error and warning lines}`` (empty where it was built
    before)."""
    from koopmanx_torch.ops import build as builder
    from koopmanx_torch.ops.qp_build import _defines

    report = {}
    for shape in shapes:
        log = builder.build_all(["qp_build"], _defines(*shape)).get(
            "qp_build", "")
        report[shape] = [ln.strip() for ln in log.splitlines()
                         if any(k in ln.lower() for k in (
                             "registers", "spill", "error", "warning"))]
    return report


def check(device, shape, batch, terminal, dtype, seed):
    """The kernel against the plain version: a row with, for P and q, the
    worst relative error and the worst ratio to the bound, the entries
    whose finiteness differs, and ``held``."""
    import torch
    from koopmanx_torch.ops import qp_build as qb

    name = str(dtype).replace("torch.", "")
    ins = random_case(batch, shape, terminal, dtype, device, seed)
    horizon = shape[3]
    got = qb.qp_build(*ins, horizon, F_CLAMP)
    ref = qb.plain(*ins, horizon, F_CLAMP)
    nudged = []
    if dtype == torch.float32:
        a = ins[0]
        nudged = [qb.plain(torch.nextafter(a, torch.full_like(a, t)),
                           *ins[1:], horizon, F_CLAMP)
                  for t in (float("inf"), -float("inf"))]
    row = {"shape": list(shape), "batch": batch, "terminal": terminal,
           "dtype": name, "rtol": RTOL[name], "worst_rel": [],
           "worst_ratio_to_bound": [], "finite_differs": []}
    for i, (g, r) in enumerate(zip(got, ref)):
        flat = lambda t: t.reshape(batch, -1).double()  # noqa: E731
        g, r = flat(g), flat(r)
        row["finite_differs"].append(
            int((torch.isfinite(g) != torch.isfinite(r)).sum()))
        amax = lambda t: t.abs().amax(-1)  # noqa: E731
        scale = amax(r)
        bound = RTOL[name] * scale
        if nudged:
            floor = torch.stack([amax(flat(v[i]) - r) for v in nudged])
            bound = torch.maximum(bound, 10.0 * floor.amax(0))
        diff = amax(g - r)
        row["worst_rel"].append(float((diff / scale.clamp_min(1e-300)).max()))
        row["worst_ratio_to_bound"].append(
            float((diff / bound.clamp_min(1e-300)).max()))
    row["held"] = (not any(row["finite_differs"])
                   and all(v <= 1.0 for v in row["worst_ratio_to_bound"]))
    return row


def timing(device, cell, batch, shape, terminal):
    """Device ms of the kernel and of the plain version in float32 at the
    cell's shape, beside the bound and the launch shape."""
    import torch
    from benchmark.roofline import HBM_BYTES_PER_S, PEAK_FLOPS, least_seconds
    from koopmanx_torch.ops import qp_build as qb
    from tools.check_dare_terminal import event_ms

    ins = random_case(batch, shape, terminal, torch.float32, device, 7)
    horizon = shape[3]
    kern = event_ms(lambda: qb.qp_build(*ins, horizon, F_CLAMP), 50)
    plain_ms = event_ms(lambda: qb.plain(*ins, horizon, F_CLAMP), 5,
                        warm=1)
    flops, nbytes = work(batch, *shape, terminal)
    bound = least_seconds(flops, nbytes) * 1e3
    return {"cell": cell, "batch": batch, "shape": list(shape),
            "terminal": terminal, "kernel_ms": kern, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         > flops / PEAK_FLOPS[4] else "operations"),
            "flops": flops, "bytes": nbytes,
            "roofline_pct": 100.0 * bound / kern,
            "launch_shape": qb.launch_shape(torch.float32, batch,
                                            *shape)._asdict()}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("check_qp_build: no CUDA device", file=sys.stderr)
        return 2
    from koopmanx_torch.device import card_line, resolve_device

    dev = resolve_device(None)  # TF32 off
    shapes = [shape for _, _, shape, _ in CELLS] + EDGES
    ptxas = build(shapes)
    report = {"card": card_line(),
              "ptxas": {"x".join(map(str, s)): v for s, v in ptxas.items()},
              "checks": [], "timing": []}
    for shape, lines in ptxas.items():
        for ln in lines:
            print(f"nvcc {shape}: {ln}", flush=True)
    runs = [(shape, 97, i % 2 == 0) for i, shape in enumerate(shapes)]
    runs += [(shape, batch, term) for _, batch, shape, term in CELLS]
    for i, (shape, batch, term) in enumerate(runs):
        for dtype in (torch.float64, torch.float32):
            row = check(dev, shape, batch, term, dtype, seed=i)
            report["checks"].append(row)
            print("check " + json.dumps(row), flush=True)
    for cell, batch, shape, term in CELLS:
        row = timing(dev, cell, batch, shape, term)
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
