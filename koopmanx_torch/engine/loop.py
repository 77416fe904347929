"""The closed-loop engine (counterpart of ``koopmanx/engine/loop.py:61-338``).

One control step for every scenario at once:

  encode -> condensed QP -> box ADMM -> apply input (or accumulate du)
  -> plant step -> re-encode -> online update of [A B] and C (square-root
  RLS, or the window's ring and refit) -> guard -> log

JAX ran one step per scenario under ``vmap`` inside a ``lax.scan``; here
every tensor carries the scenario axis first and time is a Python loop.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch
from torch import Tensor

from ..lifts.base import Dictionary
from ..systems.base import System, as_params, make_step, make_switch_schedule
from ..types import LinearModel
from .core import (
    EngineConfig,
    MPCParams,
    change_reset,
    dual_dim,
    make_control_solver,
    make_estimator_update,
)

__all__ = ["EngineConfig", "MPCParams", "LoopCarry", "StepLog",
           "make_closed_loop", "run_batch"]


class LoopCarry(NamedTuple):
    x: Tensor  # (B, n) plant state
    u_applied: Tensor  # (B, m) last applied input (the du accumulator)
    model: LinearModel
    rls: Any  # SqrtRLSState or WindowState
    warm_x: Tensor  # (B, N*m) QP primal warm start
    warm_y: Any  # (B, dual_dim) QP dual warm start under qp_warm_start='full'
    res_ema: Tensor  # (B,) running residual average (change detection)


class StepLog(NamedTuple):
    """Per-step logs, stacked to (B, T, ...) (the non-Revise_2 fields)."""

    x: Tensor
    u: Tensor
    r: Tensor
    drift_a: Tensor
    drift_b: Tensor
    drift_c: Tensor
    residual: Tensor
    qp_primal_res: Tensor


def _matvec(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def make_closed_loop(system: System, dictionary: Dictionary,
                     cfg: EngineConfig, ref_fn: Callable[[int], Tensor]):
    """Build ``closed_loop(params, x0, model0, rls0, theta0=None,
    theta1=None) -> (LoopCarry, StepLog)`` over a batch of scenarios: every
    argument carries a leading scenario axis B; plant parameters may also
    be shared scalars (None = the system's nominal and switched values)."""
    plant_step = make_step(system, cfg.h, cfg.integrator)
    m = system.m
    control_solve = make_control_solver(cfg, ref_fn, m)
    estimator_update = make_estimator_update(dictionary, cfg)

    def one_step(params, carry: LoopCarry, step: int, theta_sched):
        x, model = carry.x, carry.model
        z = dictionary(x)
        dec = control_solve(params, model, z, carry.u_applied, carry.warm_x,
                            carry.warm_y, step)
        u_applied = dec.u_applied

        x_next = plant_step(x, u_applied, theta_sched(step))
        z_next = dictionary(x_next)

        # 'next' regresses C on x+ (duffing.py:943), 'same' on x
        c_target = x_next if cfg.c_pairing == "next" else x
        rls, new_model = estimator_update(carry.rls, model, z, u_applied,
                                          z_next, c_target, step)

        # change detection on the residual of the PRE-update model
        residual = torch.linalg.vector_norm(
            z_next - (_matvec(model.A, z) + _matvec(model.B, u_applied)),
            dim=-1,
        )
        rls, res_ema = change_reset(cfg, rls, carry.res_ema, residual)

        drift = [
            torch.linalg.vector_norm((new - old).flatten(1), dim=-1)
            for new, old in zip(new_model, model)
        ]
        new_carry = LoopCarry(
            x=x_next,
            u_applied=u_applied,
            model=new_model,
            rls=rls,
            warm_x=dec.warm_x,
            warm_y=dec.sol.y if cfg.qp_warm_start == "full" else carry.warm_y,
            res_ema=res_ema,
        )
        log = StepLog(
            x=x,
            u=u_applied,
            r=dec.r_window[0].expand(x.shape[0], -1),
            drift_a=drift[0],
            drift_b=drift[1],
            drift_c=drift[2],
            residual=residual,
            qp_primal_res=dec.sol.primal_res,
        )
        return new_carry, log

    def closed_loop(params: MPCParams, x0: Tensor, model0: LinearModel,
                    rls0, theta0=None, theta1=None
                    ) -> Tuple[LoopCarry, StepLog]:
        dtype, dev = x0.dtype, x0.device
        th0 = as_params(system.theta0 if theta0 is None else theta0, dtype, dev)
        th1 = as_params(system.theta1 if theta1 is None else theta1, dtype, dev)
        theta_sched = make_switch_schedule(th0, th1, cfg.switch_step)
        batch = x0.shape[0]
        zeros = lambda k: torch.zeros((batch, k), dtype=dtype, device=dev)
        carry = LoopCarry(
            x=x0,
            u_applied=zeros(m),
            model=model0,
            rls=rls0,
            warm_x=zeros(cfg.horizon * m),
            warm_y=(zeros(dual_dim(cfg, params, m))
                    if cfg.qp_warm_start == "full" else ()),
            res_ema=torch.zeros((batch,), dtype=dtype, device=dev),
        )
        logs = []
        with torch.inference_mode():
            for step in range(cfg.steps):
                carry, log = one_step(params, carry, step, theta_sched)
                logs.append(log)
        stacked = StepLog(*(torch.stack(f, dim=1) for f in zip(*logs)))
        return carry, stacked

    return closed_loop


def run_batch(closed_loop, params: MPCParams, x0: Tensor,
              model0: LinearModel, rls0, theta0=None, theta1=None):
    """Run a scenario batch: every argument carries the leading scenario
    axis (``koopmanx_torch.run.replicate`` broadcasts shared ones)."""
    return closed_loop(params, x0, model0, rls0, theta0, theta1)
