"""The local-linearization MPC baseline (counterpart of
``koopmanx/engine/local_linear.py``): the reference's Jacobian-model
comparison (``duffing.py:691-706``; ``Revise_2/Koopman_update.m:169-177``)
as a closed loop.

Each step re-linearizes the TRUE plant at the current operating point
(:func:`..systems.linearize.linearize_discrete`, exact forward-mode
Jacobians) and solves the same condensed QP through the same control
body (:func:`.core.make_control_solver`) as the Koopman engine: on the
affine lift psi(x) = [x; 1] the local model x+ = A x + B u + d is exactly
the linear model [[A, d], [0, 1]], so the engine needs no special case.
On ``qp_backend='pallas'`` every step launches the box-ADMM kernel at
nx = N*m. The linearization follows the switch schedule's plant
parameters (the baseline with perfect model knowledge, imperfect only
through the linearization).

Batched: every argument carries a leading scenario axis B where the JAX
package ``vmap``-ed one scenario's loop; time is a Python loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..lifts.base import constant_augmented
from ..systems.base import System, as_params, make_step, make_switch_schedule
from ..systems.linearize import affine_residual, linearize_discrete
from ..types import LinearModel
from .core import (
    EngineConfig,
    MPCParams,
    dual_dim,
    initial_cert,
    make_control_solver,
)

__all__ = ["LocalLinearCarry", "LocalLinearLog", "affine_augmented_model",
           "make_local_linear_loop", "run_local_linear_batch"]


class LocalLinearCarry(NamedTuple):
    x: Tensor  # (B, n)
    u_applied: Tensor  # (B, m)
    warm_x: Tensor  # (B, N*m)
    warm_y: object  # (B, dual_dim) under qp_warm_start='full', else ()
    cert: tuple = ()


class LocalLinearLog(NamedTuple):
    """Per-step logs, stacked to (B, T, ...)."""

    x: Tensor
    u: Tensor
    r: Tensor
    qp_primal_res: Tensor


def affine_augmented_model(loc: LinearModel, d: Tensor) -> LinearModel:
    """The affine local model (A, B, d) as the exact linear model on
    psi(x) = [x; 1] (``local_linear.py:54-64``): A' = [[A, d], [0, 1]],
    B' = [B; 0], C' = [I 0]; batched."""
    n, m = loc.A.shape[-1], loc.B.shape[-1]
    batch = loc.A.shape[:-2]
    kw = dict(dtype=loc.A.dtype, device=loc.A.device)
    a_aug = torch.zeros(batch + (n + 1, n + 1), **kw)
    a_aug[..., :n, :n] = loc.A
    a_aug[..., :n, n] = d
    a_aug[..., n, n] = 1.0
    b_aug = torch.cat([loc.B, torch.zeros(batch + (1, m), **kw)], dim=-2)
    c_aug = torch.cat([torch.eye(n, **kw), torch.zeros((n, 1), **kw)], -1)
    return LinearModel(A=a_aug, B=b_aug, C=c_aug.expand(batch + c_aug.shape))


def make_local_linear_loop(system: System, cfg: EngineConfig,
                           ref_fn: Callable[[int], Tensor]):
    """Build ``closed_loop(params, x0, theta0=None, theta1=None, u0=None)
    -> (LocalLinearCarry, LocalLinearLog)`` over a batch of scenarios
    (``local_linear.py:67-160``): the call of
    :func:`.loop.make_closed_loop` without the model and estimator, which
    each step re-derives from the plant at (x, u_prev) under the
    scheduled parameters."""
    plant_step = make_step(system, cfg.h, cfg.integrator)
    n, m = system.n, system.m
    aug = constant_augmented(n)
    control_solve = make_control_solver(cfg, ref_fn, m, aug)

    def one_step(params, carry: LocalLinearCarry, step: int, theta):
        x, u_prev = carry.x, carry.u_applied
        # exact per-step refit: the Jacobian of the one-step map
        loc = linearize_discrete(system, x, u_prev, cfg.h, theta,
                                 cfg.integrator)
        d = affine_residual(system, x, u_prev, loc, cfg.h, theta,
                            cfg.integrator)
        dec = control_solve(params, affine_augmented_model(loc, d), aug(x),
                            u_prev, carry.warm_x, carry.warm_y, step,
                            carry.cert, x)
        x_next = plant_step(x, dec.u_applied, theta)
        new_carry = LocalLinearCarry(
            x=x_next,
            u_applied=dec.u_applied,
            warm_x=dec.warm_x,
            warm_y=dec.sol.y if cfg.qp_warm_start == "full" else carry.warm_y,
            cert=dec.cert,
        )
        log = dict(x=x, u=dec.u_applied,
                   r=dec.r_window[..., 0, :].expand(x.shape[0], -1),
                   qp_primal_res=dec.sol.primal_res)
        return new_carry, log

    def closed_loop(params: MPCParams, x0: Tensor, theta0=None, theta1=None,
                    u0: Optional[Tensor] = None
                    ) -> Tuple[LocalLinearCarry, LocalLinearLog]:
        dtype, dev = x0.dtype, x0.device
        th0 = as_params(system.theta0 if theta0 is None else theta0, dtype, dev)
        th1 = as_params(system.theta1 if theta1 is None else theta1, dtype, dev)
        theta_sched = make_switch_schedule(th0, th1, cfg.switch_step)
        batch = x0.shape[0]
        zeros = lambda k: torch.zeros((batch, k), dtype=dtype, device=dev)
        carry = LocalLinearCarry(
            x=x0,
            u_applied=zeros(m) if u0 is None else u0,
            warm_x=zeros(cfg.horizon * m),
            warm_y=(zeros(dual_dim(cfg, params, m))
                    if cfg.qp_warm_start == "full" else ()),
            cert=initial_cert(cfg, params, aug.nlift, m, batch, dtype, dev),
        )
        logs = []
        with torch.inference_mode():
            for step in range(cfg.steps):
                carry, log = one_step(params, carry, step, theta_sched(step))
                logs.append(log)
        return carry, LocalLinearLog(**{
            k: torch.stack([log[k] for log in logs], dim=1) for k in logs[0]})

    return closed_loop


def run_local_linear_batch(closed_loop, params: MPCParams, x0: Tensor,
                           theta0=None, theta1=None):
    """Run a scenario batch (the JAX package ``vmap``-s one scenario's
    loop): ``params`` with the leading scenario axis
    (``koopmanx_torch.run.replicate`` broadcasts shared ones)."""
    return closed_loop(params, x0, theta0, theta1)
