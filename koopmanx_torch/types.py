"""Core types (counterpart of ``koopmanx/types.py:24-130``).

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


class RLSState(NamedTuple):
    """Carry of the rank-one Sherman-Morrison RLS (``update='rls'``):
    ``K_A``/``invG`` track the [A B] regression (``K_A += z+ [z;u]'``,
    ``invG`` the inverse Gram of [z;u]; duffing.py:927-938), ``barX``/
    ``barQ`` the output map C (duffing.py:942-953)."""

    K_A: Tensor  # (..., N, N+m)
    invG: Tensor  # (..., N+m, N+m)
    barX: Tensor  # (..., p, N)
    barQ: Tensor  # (..., N, N)


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


def model_from_rls(state: RLSState, nlift: int) -> LinearModel:
    """``K_ext = K_A invG`` sliced into [A B] (duffing.py:938, 978-981) and
    ``C = barX barQ`` (duffing.py:953). Estimator math: full float32, which
    the entry points pin (TF32 off, ``device.resolve_device``)."""
    k_ext = state.K_A @ state.invG
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:],
                       C=state.barX @ state.barQ)
