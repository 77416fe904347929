"""Peaks of one NVIDIA H100 SXM and the work of the stages whose rooflines
the benchmark reports, counted from their shapes.

The peaks are NVIDIA's data sheet's (dense, no sparsity), at the card's
full 700 W: 67 TFLOP/s in float32 outside the tensor cores, 34 in
float64, 3.35 TB/s of HBM (copied from ``chip_smoke.py``). A stage's least
time is the larger of its operations over the peak rate and its bytes
over the memory rate, each input byte read once and each output byte
written once. An FMA counts two operations; a dense n x n inverse 2 n^3
(LU and the two triangular inversions); a product of (a, b) and (b, c)
2 a b c.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # by item size: float32, float64


def least_seconds(flops: float, nbytes: float, itemsize: int = 4) -> float:
    return max(flops / PEAK_FLOPS[itemsize], nbytes / HBM_BYTES_PER_S)


def qp_solve_work(batch: int, nx: int, iters: int, itemsize: int = 4
                  ) -> Tuple[float, float]:
    """(operations, bytes) of the box QP of ``batch`` scenarios with nx
    decisions: rho from P's trace, the KKT matrix P + (sigma + rho) I and
    its inverse, then ``iters`` ADMM iterations of ``box_admm``'s count
    (a matrix-vector product and 12 vector operations each); P, q, the two
    bounds and the warm start read once, the solution written once."""
    flops = batch * (2 * nx + 2 * nx ** 3 + iters * (2 * nx * nx + 12 * nx))
    nbytes = batch * itemsize * (nx * nx + 4 * nx + nx)
    return flops, nbytes


def terminal_work(batch: int, nz: int, m: int, iters: int, itemsize: int = 4
                  ) -> Tuple[float, float]:
    """(operations, bytes) of the terminal synthesis of ``batch`` models
    (nz states, m inputs): G = B R^-1 B'; ``iters`` doubling steps, each
    eleven nz x nz products or inverses (G H, (I + G H)^-1, W = that times
    A, A W, H G, (I + H G)^-1, that times A', A G, their product, W' H,
    that times A) and four nz x nz sums; the gain K = (R + B'PB)^-1 B'PA
    and gamma = trace P. A and B read once, Q_lift and R once for the
    batch, P, K and gamma written once."""
    setup = 2 * m ** 3 + 2 * m * m * nz + 2 * nz * nz * m
    step = 22 * nz ** 3 + 4 * nz * nz
    gain = 4 * m * nz * nz + 4 * m * m * nz + m * m + 2 * m ** 3 + nz
    flops = batch * (setup + iters * step + gain)
    nbytes = itemsize * (batch * (nz * nz + nz * m + nz * nz + m * nz + 1)
                         + nz * nz + m * m)
    return flops, nbytes
