"""Core types (counterpart of ``koopmanx/types.py:24-130``, with
``ClosedLoopLog`` at :99-113).

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


class ClosedLoopLog(NamedTuple):
    """Per-step outputs of one closed loop, stacked over time: the
    quantities the reference logs per step (``duffing.py:985-990``, the
    drift norms; ``Revise_2/Koopman_update.m:253``, the residual). The
    engine's ``StepLog`` holds these and more."""

    x: Tensor  # plant state (T, n)
    u: Tensor  # applied input (T, m)
    r: Tensor  # reference head (T, p)
    drift_a: Tensor  # ||A_k+1 - A_k||_F (T,)
    drift_b: Tensor
    drift_c: Tensor
    residual: Tensor  # ||z+ - (A z + B u)||, the one-step lifted residual


def model_from_rls(state: RLSState, nlift: int) -> LinearModel:
    """``K_ext = K_A invG`` sliced into [A B] (duffing.py:938, 978-981) and
    ``C = barX barQ`` (duffing.py:953). Estimator math: full float32, which
    the entry points pin (TF32 off, ``device.resolve_device``)."""
    k_ext = state.K_A @ state.invG
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:],
                       C=state.barX @ state.barQ)
