"""The work of the windowed estimator's Woodbury update a step, counted
from its equations, the same whatever implements them, in the
conventions of :mod:`benchmark.roofline` (an FMA two operations, a product
of (a, b) and (b, c) 2 a b c, each input byte read once and each output
byte written once).

A scenario's step, with nz lifted states, m inputs, n outputs and
d = nz + m, for k = d (the Gram of [z u]) and k = nz (the Gram of z):

- the motion: each Gram by rank 2 (add the new row's outer product,
  remove the evicted one's: 4 k^2), each cross-Gram by rank 1 each way
  (4 d nz for [z u]' z+, 4 nz n for z' x);
- four Sherman-Morrison steps, two on each inverse, each a k x k
  matrix-vector product (2 k^2), the denominator (2 k) and the outer
  update (2 k^2);
- ``polish`` Newton-Schulz steps on each inverse, each two k x k
  products (4 k^3);
- the model: g^-1 mg as the inverse's product refined once (k = X r,
  then k + X (r - G k)): three products (6 d^2 nz) and the residual and
  correction (2 d nz); gz^-1 mc refined twice: five products (10 nz^2 n)
  and two residuals and corrections (4 nz n);
- the model guard: ``guard_iters`` power iterations of A (2 nz^2 each)
  and the finiteness pass (no operation);
- bytes: the carried statistics (both Grams, both inverses, both
  cross-Grams; gz and mc in float64, 8 bytes an entry) read and written
  once, the evicted ring row read, the new one (the observation) read
  and written, the model written.
"""
from __future__ import annotations

from typing import Optional, Tuple

GUARD_ITERS = 12  # the model guard's power iterations


def woodbury_work(batch: int, nz: int, m: int, n: int, polish: int,
                  itemsize: int = 4, guard_iters: int = GUARD_ITERS
                  ) -> Tuple[float, float]:
    """(operations, bytes) of one step of ``batch`` scenarios."""
    d = nz + m
    motion = 4 * d * d + 4 * nz * nz + 4 * d * nz + 4 * nz * n
    sm = sum(2 * (4 * k * k + 2 * k) for k in (d, nz))
    newton = sum(polish * 4 * k ** 3 for k in (d, nz))
    model = 6 * d * d * nz + 10 * nz * nz * n + 2 * d * nz + 4 * nz * n
    guard = guard_iters * 2 * nz * nz
    flops = batch * (motion + sm + newton + model + guard)
    stats = 2 * d * d + nz * nz + d * nz
    row = nz + m + nz + n
    nbytes = batch * (itemsize * (2 * stats + 3 * row + nz * d + n * nz)
                      + 8 * 2 * (nz * nz + nz * n))
    return flops, nbytes


def config_work(rec: dict, config: dict) -> Optional[Tuple[float, float]]:
    """:func:`woodbury_work` of a run's record (its fleet, its lifted width,
    its inputs and item size) at the configuration's polish and outputs,
    which the record lacks; None where the run's lifted width is not the
    configuration's (nlift, plus the n states where state-augmented)."""
    rc, n = config["run_config"], config["plant"]["n"]
    lift = rc["lift"]
    nz = lift["nlift"] + (n if lift["state_augmented"] else 0)
    if rec.get("nlift") != nz:
        return None
    return woodbury_work(rec["batch"], nz, rec["m"], n,
                         rc["update"]["window_polish"], rec["itemsize"])
