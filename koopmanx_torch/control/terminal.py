"""Terminal-cost synthesis and the stability monitors of Revise_2
(counterpart of ``koopmanx/control/terminal.py``).

The reference re-certifies stability every control step with an LMI
(``Revise_2/Koopman_update.m:314-381``); the JAX package's default, and
the port's, synthesizes the terminal pair from the DARE of the current
(online-updated) model instead:

  P = DARE(A, B, Q_lift, R),  K = dlqr gain (u = -K z),  gamma = trace P

and reproduces the per-step monitor series as functions. Every function
takes a leading scenario axis where the JAX package was ``vmap``-ed:
models (B, nz, nz) etc., vectors (B, k), scalars (B,).
"""
from __future__ import annotations

from typing import NamedTuple

from torch import Tensor

from ..ops.linalg import cholesky
from ..types import LinearModel
from ..utils import profiling
from .dare import dlqr_gain, solve_dare_doubling


class TerminalCert(NamedTuple):
    p: Tensor  # terminal cost (B, nz, nz)
    k: Tensor  # terminal gain (B, m, nz), u = -K z
    gamma: Tensor  # ellipsoid level (B,), trace P


def _mv(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def quad_form(v: Tensor, p: Tensor, w: Tensor) -> Tensor:
    """v' P w per scenario, as (v @ P) @ w."""
    return ((v.unsqueeze(-2) @ p).squeeze(-2) * w).sum(-1)


def synthesize_terminal(model: LinearModel, q_lift: Tensor, r: Tensor,
                        iters: int = 30) -> TerminalCert:
    """The DARE certificate of each scenario's model (``terminal.py:
    45-55``): P by doubling, K its gain, gamma = trace P."""
    with profiling.span("kx.terminal"):
        p = solve_dare_doubling(model.A, model.B, q_lift, r, iters=iters)
        k = dlqr_gain(model.A, model.B, q_lift, r, p)
        gamma = p.diagonal(dim1=-2, dim2=-1).sum(-1)
        return TerminalCert(p=p, k=k, gamma=gamma)


def prediction_residual(model: LinearModel, z: Tensor, u: Tensor,
                        x_next: Tensor) -> Tensor:
    """||x+ - C (A z + B u)|| (Revise_2/Koopman_update.m:253)."""
    z_pred = _mv(model.A, z) + _mv(model.B, u)
    return (x_next - _mv(model.C, z_pred)).norm(dim=-1)


def lifted_residual(model: LinearModel, z: Tensor, u: Tensor,
                    z_next: Tensor) -> Tensor:
    """||z+ - (A z + B u)||, the lifted one-step model error."""
    return (z_next - (_mv(model.A, z) + _mv(model.B, u))).norm(dim=-1)


def lyapunov_value(p: Tensor, psi_err: Tensor) -> Tensor:
    """V = psi(x - r)' P psi(x - r) (Revise_2/Koopman_update.m:382-384)."""
    return quad_form(psi_err, p, psi_err)


def ellipsoid_radius(p: Tensor, c: Tensor, gamma: Tensor) -> Tensor:
    """chol(C P C' / gamma), the invariant-ellipsoid section of
    Revise_2/Koopman_update.m:521-535; NaN below the diagonal where
    C P C' / gamma is not positive definite, as in the JAX package."""
    cpc = c @ p @ c.transpose(-1, -2)
    return cholesky(cpc / gamma[..., None, None])


def compensator_term(model: LinearModel, k: Tensor, z: Tensor, u: Tensor,
                     z_next: Tensor) -> Tensor:
    """K (z+ - (A z + B u)), the residual feedback the reference logs
    (Revise_2/Koopman_update.m:251)."""
    return _mv(k, z_next - (_mv(model.A, z) + _mv(model.B, u)))


def gamma_margin(p: Tensor, c: Tensor, gamma: Tensor, psi_err: Tensor,
                 x_err: Tensor) -> Tensor:
    """gamma - (V - x_err' C P C' x_err), the invariant-set margin series
    (Revise_2/Koopman_update.m:385)."""
    v = quad_form(psi_err, p, psi_err)
    cpc = c @ p @ c.transpose(-1, -2)
    return gamma - (v - quad_form(x_err, cpc, x_err))
