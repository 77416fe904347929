"""Core types (counterpart of ``koopmanx/types.py:24-97``).

Every leaf is a ``torch.Tensor`` with a leading scenario axis where the
engine batches (JAX batched the same types with ``vmap``).
"""
from __future__ import annotations

from typing import NamedTuple

from torch import Tensor


class LinearModel(NamedTuple):
    """Lifted linear predictor ``z+ = A z + B u``, ``y = C z``.

    Shapes (with leading batch dims): A (..., N, N), B (..., N, m),
    C (..., p, N).
    """

    A: Tensor
    B: Tensor
    C: Tensor


class QPData(NamedTuple):
    """A dense QP in OSQP standard form (counterpart of
    ``koopmanx/types.py:71-85``).

    minimize   1/2 x^T P x + q^T x
    subject to l <= A x <= u

    Box bounds are identity rows in ``A``. Shapes (with leading batch
    dims): P (nx, nx), q (nx,), A (nc, nx), l (nc,), u (nc,).
    """

    P: Tensor
    q: Tensor
    A: Tensor
    l: Tensor
    u: Tensor


class QPSolution(NamedTuple):
    """Primal/dual solution and residuals of the batched ADMM solver."""

    x: Tensor
    z: Tensor
    y: Tensor
    primal_res: Tensor
    dual_res: Tensor
    iterations: int
