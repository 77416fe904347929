"""The closed-loop engine (counterpart of ``koopmanx/engine/loop.py:61-338``).

One control step for every scenario at once:

  encode -> (terminal synthesis + certificate guard) -> condensed QP ->
  box ADMM -> apply input (or accumulate du) -> plant step -> re-encode
  -> online update of [A B] and C -> guard -> log, with the Revise_2
  monitor series under terminal synthesis

JAX ran one step per scenario under ``vmap`` inside a ``lax.scan``; here
every tensor carries the scenario axis first and time is a Python loop.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from ..control.terminal import quad_form
from ..lifts.base import Dictionary
from ..systems.base import System, as_params, make_step, make_switch_schedule
from ..tree import tree_leaves
from ..types import LinearModel
from ..utils import profiling
from .core import (
    EngineConfig,
    MPCParams,
    _matnorm,
    change_reset,
    dual_dim,
    initial_cert,
    initial_kkt_inv,
    make_control_solver,
    make_estimator_update,
)

__all__ = ["EngineConfig", "MPCParams", "LoopCarry", "StepLog",
           "make_closed_loop", "records_graph", "run_batch"]


class LoopCarry(NamedTuple):
    x: Tensor  # (B, n) plant state
    u_applied: Tensor  # (B, m) last applied input (the du accumulator)
    model: LinearModel
    rls: Any  # SqrtRLSState or WindowState
    warm_x: Tensor  # (B, N*m) QP primal warm start
    warm_y: Any  # (B, dual_dim) QP dual warm start under qp_warm_start='full'
    res_ema: Tensor  # (B,) running residual average (change detection)
    # the last certificate (P, K, gamma) that passed the guard, per
    # scenario, under terminal synthesis; () otherwise
    cert: Any = ()
    # the carried KKT inverse (B, N*m, N*m) under qp_kkt_refine, else ()
    kkt_inv: Any = ()


class StepLog(NamedTuple):
    """Per-step logs, stacked to (B, T, ...). The Lyapunov value and the
    Revise_2 monitor series (``loop.py:86-108``) are zeros, and
    ``cert_fresh`` all True, unless terminal synthesis runs; then every
    monitor reads the PRE-update model, as the reference logs before its
    RLS block (Revise_2/Koopman_update.m:251-254)."""

    x: Tensor
    u: Tensor
    r: Tensor
    drift_a: Tensor
    drift_b: Tensor
    drift_c: Tensor
    residual: Tensor
    qp_primal_res: Tensor
    lyapunov: Tensor  # V = psi(x - r)' P psi(x - r) (:382-384)
    gamma: Tensor  # the certificate's level (:369)
    eps_state: Tensor  # ||x+ - C(Az + Bu)|| (:253)
    eps_op: Tensor  # ||z+ - (Az + Bu)|| / ||z|| (:254)
    compensator: Tensor  # (m,) K (z+ - (Az + Bu)) (:251)
    gamma_margin: Tensor  # gamma - (V - e' CPC' e); gamma - V if lifted
    compare_state: Tensor  # u'Ru - (A^N N psi(e))' P (A^N N psi(e)) (:386)
    minus_set: Tensor  # z'Q_lift z - |2 z+' P (z+ - (Az + Bu))| (:374)
    ellipse: Tensor  # (py, py) the terminal block / gamma (:521-535)
    cert_fresh: Tensor  # bool: this step's synthesis passed the guard


REVISE2_FIELDS = StepLog._fields[8:]


def _matvec(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def revise2_monitors(dictionary: Dictionary, cfg: EngineConfig,
                     params: MPCParams, dec, model: LinearModel, x: Tensor,
                     z: Tensor, u: Tensor, x_next: Tensor, z_next: Tensor):
    """The Revise_2 per-step monitor series of ``loop.py:187-235`` on the
    PRE-update ``model`` and the held certificate of ``dec``, as a dict of
    StepLog fields (``cert_fresh`` aside), each with a leading scenario
    axis."""
    p, gamma = dec.p_lyap, dec.cert_gamma
    psi_err = dictionary(x - dec.ref_full)
    lyap = quad_form(psi_err, p, psi_err)
    z_pred = _matvec(model.A, z) + _matvec(model.B, u)
    res_vec = z_next - z_pred
    e_pred = x_next - _matvec(model.C, z_pred)
    if cfg.track_lifted:
        # C = I: the output-space term of :385 coincides with V, so log
        # the ellipsoid membership margin gamma - V
        g_margin = gamma - lyap
    else:
        x_err = x - dec.ref_full
        e_out = x_err if params.cy is None else _matvec(params.cy, x_err)
        g_margin = gamma - (lyap - quad_form(e_out, dec.terminal, e_out))
    # Compare_State (:386): u'Ru against the N-step amplified prediction
    # error under the terminal cost
    a_pow = torch.linalg.matrix_power(model.A, cfg.horizon)
    amp = _matvec(a_pow, dictionary(e_pred)) * cfg.horizon
    return dict(
        lyapunov=lyap,
        gamma=gamma,
        eps_state=torch.linalg.vector_norm(e_pred, dim=-1),
        # the Frobenius norm of the rank-one res_vec z' / ||z||^2
        # (epsilon_Decomposition, :254)
        eps_op=torch.linalg.vector_norm(res_vec, dim=-1) / torch.clamp(
            torch.linalg.vector_norm(z, dim=-1), min=1e-30),
        compensator=_matvec(dec.cert_k, res_vec),
        gamma_margin=g_margin,
        compare_state=(quad_form(u, params.r_block, u)
                       - quad_form(amp, p, amp)),
        minus_set=quad_form(z, params.q_lift, z)
        - torch.abs(2.0 * quad_form(z_next, p, res_vec)),
        ellipse=dec.terminal / torch.clamp(gamma, min=1e-30)[..., None, None],
    )


def records_graph(*inputs) -> bool:
    """Whether the loop records the autograd graph: grad mode is on and
    some tensor leaf of ``inputs`` requires grad. Otherwise it runs under
    ``torch.inference_mode()``."""
    return torch.is_grad_enabled() and any(
        isinstance(leaf, Tensor) and leaf.requires_grad
        for leaf in tree_leaves(inputs))


def make_closed_loop(system: System, dictionary: Dictionary,
                     cfg: EngineConfig, ref_fn: Callable[[int], Tensor]):
    """Build ``closed_loop(params, x0, model0, rls0, theta0=None,
    theta1=None, u0=None, carry0=None, step_offset=0) -> (LoopCarry,
    StepLog)`` over a batch of scenarios: every argument carries a leading
    scenario axis B; plant parameters may also be shared scalars (None =
    the system's nominal and switched values). ``u0`` seeds the applied
    input (the du accumulator); ``carry0`` resumes from an earlier run's
    carry (``x0``, ``model0``, ``rls0`` and ``u0`` are then unused) and
    ``step_offset`` numbers its steps from there, so a run cut into
    chunks is the uncut run (``koopmanx/engine/loop.py:279-319``).
    ``closed_loop.initial_carry(params, x0, model0, rls0, u0=None)`` is
    the carry a run starts from.

    Autograd: the loop records the graph, as ``jax.grad`` differentiates
    the JAX loop, when :func:`records_graph` says so (grad mode on and a
    tensor leaf of ``params``, ``x0``, ``model0``, ``rls0``, the plant
    parameters, ``u0`` or ``carry0`` requires grad); otherwise it runs
    under ``torch.inference_mode()``, as every forward-only caller does.
    Under ``cfg.remat`` each recorded step is checkpointed
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of
    ``jax.checkpoint(body)`` (``koopmanx/engine/loop.py:319-320``): the
    backward pass recomputes it from its carry. The kernel route
    (``qp_backend='pallas'``) raises ``ValueError`` under autograd; the
    differentiable route is ``'xla'``, as in the JAX package."""
    plant_step = make_step(system, cfg.h, cfg.integrator)
    m = system.m
    control_solve = make_control_solver(cfg, ref_fn, m, dictionary)
    estimator_update = make_estimator_update(dictionary, cfg)

    def one_step(params, carry: LoopCarry, step: int, theta_sched):
        with profiling.span("kx.step", {"step": step}):
            profiling.count("step.rows", carry.x.shape[0])
            return _step(params, carry, step, theta_sched)

    def _step(params, carry: LoopCarry, step: int, theta_sched):
        x, model = carry.x, carry.model
        z = dictionary(x)
        dec = control_solve(params, model, z, carry.u_applied, carry.warm_x,
                            carry.warm_y, step, carry.cert, x, carry.kkt_inv)
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

        # the model's drift per step: Frobenius norms, or the largest
        # singular values under drift_norm='spectral' (loop.py:163-185)
        drift = [_matnorm(new - old, cfg.drift_norm)
                 for new, old in zip(new_model, model)]
        new_carry = LoopCarry(
            x=x_next,
            u_applied=u_applied,
            model=new_model,
            rls=rls,
            warm_x=dec.warm_x,
            warm_y=dec.sol.y if cfg.qp_warm_start == "full" else carry.warm_y,
            res_ema=res_ema,
            cert=dec.cert,
            kkt_inv=dec.kkt_inv,
        )
        log = dict(
            x=x,
            u=u_applied,
            r=dec.r_window[0].expand(x.shape[0], -1),
            drift_a=drift[0],
            drift_b=drift[1],
            drift_c=drift[2],
            residual=residual,
            qp_primal_res=dec.sol.primal_res,
        )
        if cfg.terminal_synthesis:
            log.update(revise2_monitors(dictionary, cfg, params, dec, model,
                                        x, z, u_applied, x_next, z_next),
                       cert_fresh=dec.cert_ok)
        return new_carry, log

    def initial_carry(params: MPCParams, x0: Tensor, model0: LinearModel,
                      rls0, u0: Optional[Tensor] = None) -> LoopCarry:
        dtype, dev = x0.dtype, x0.device
        batch = x0.shape[0]
        zeros = lambda k: torch.zeros((batch, k), dtype=dtype, device=dev)
        return LoopCarry(
            x=x0,
            u_applied=zeros(m) if u0 is None else u0,
            model=model0,
            rls=rls0,
            warm_x=zeros(cfg.horizon * m),
            warm_y=(zeros(dual_dim(cfg, params, m))
                    if cfg.qp_warm_start == "full" else ()),
            res_ema=torch.zeros((batch,), dtype=dtype, device=dev),
            cert=initial_cert(cfg, params, dictionary.nlift, m, batch,
                              dtype, dev),
            kkt_inv=initial_kkt_inv(cfg, m, batch, dtype, dev),
        )

    def closed_loop(params: MPCParams, x0: Tensor, model0: LinearModel,
                    rls0, theta0=None, theta1=None, u0: Optional[Tensor] = None,
                    carry0: Optional[LoopCarry] = None, step_offset: int = 0
                    ) -> Tuple[LoopCarry, StepLog]:
        dtype, dev = x0.dtype, x0.device
        th0 = as_params(system.theta0 if theta0 is None else theta0, dtype, dev)
        th1 = as_params(system.theta1 if theta1 is None else theta1, dtype, dev)
        theta_sched = make_switch_schedule(th0, th1, cfg.switch_step)
        batch = x0.shape[0]
        carry = (initial_carry(params, x0, model0, rls0, u0)
                 if carry0 is None else carry0)
        grad = records_graph(params, x0, model0, rls0, th0, th1, u0, carry0)
        step_fn = one_step
        if grad and cfg.remat:
            step_fn = lambda *args: checkpoint(one_step, *args,
                                               use_reentrant=False)
        logs = []
        with (contextlib.nullcontext() if grad else torch.inference_mode()):
            for step in range(step_offset, step_offset + cfg.steps):
                carry, log = step_fn(params, carry, step, theta_sched)
                logs.append(log)
        stacked = {k: torch.stack([log[k] for log in logs], dim=1)
                   for k in logs[0]}
        if not cfg.terminal_synthesis:
            # zeros and an all-True cert_fresh, as zero-stride views
            py = params.q_block.shape[-1]
            shapes = dict.fromkeys(REVISE2_FIELDS, ())
            shapes.update(compensator=(m,), ellipse=(py, py))
            for k, shape in shapes.items():
                like = (torch.ones((), dtype=torch.bool, device=dev)
                        if k == "cert_fresh" else
                        torch.zeros((), dtype=dtype, device=dev))
                stacked[k] = like.expand((batch, cfg.steps) + shape)
        return carry, StepLog(**stacked)

    closed_loop.initial_carry = initial_carry
    return closed_loop


def run_batch(closed_loop, params: MPCParams, x0: Tensor,
              model0: LinearModel, rls0, theta0=None, theta1=None):
    """Run a scenario batch: every argument carries the leading scenario
    axis (``koopmanx_torch.run.replicate`` broadcasts shared ones)."""
    return closed_loop(params, x0, model0, rls0, theta0, theta1)
