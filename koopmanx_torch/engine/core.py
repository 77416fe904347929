"""The per-step MPC body (counterpart of ``koopmanx/engine/core.py``).

The slice ports the box path of ``make_control_solver`` (:383-729), the
``rls_sqrt`` branch of ``make_estimator_update`` (:914-921) with the model
guard (:988-1008) applied per scenario, and ``change_reset``
(:1015-1047). Every function takes a leading scenario axis where the JAX
package was ``vmap``-ed. Options of paths not ported yet raise
``NotImplementedError`` naming their ROADMAP item (:func:`check_supported`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import Tensor

from ..control.condensed import (
    block_diag_repeat,
    condensed_qp,
    prediction_matrices,
    weight_bar,
)
from ..control.qp import ADMMConfig, make_box_qp_solver
from ..edmd.rls import sqrt_rls_model, sqrt_rls_update_ab, sqrt_rls_update_c
from ..lifts.base import Dictionary
from ..types import LinearModel, QPSolution


class MPCParams(NamedTuple):
    """Runtime MPC parameters, per scenario (leading batch axis in the
    engine)."""

    q_block: Tensor  # (py, py) stage output weight
    r_block: Tensor  # (m, m) stage input weight
    u_min: Tensor  # (m,) input bounds
    u_max: Tensor
    cy: Optional[Tensor] = None  # (py, p) output selector; None = track C z
    ref_state: Optional[Tensor] = None  # (n,) state-space reference anchor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (field names and defaults of the JAX
    ``EngineConfig``; only fields the port reads or refuses are kept)."""

    horizon: int = 10
    steps: int = 1000
    h: float = 0.05
    integrator: str = "rk4"
    controller: str = "mpc"
    delta_u: bool = False
    track_lifted: bool = False
    update: str = "rls"
    c_pairing: str = "next"  # 'next' (duffing.py:943) | 'same'
    rls_lambda: float = 1.0
    rls_ridge: float = 0.0
    switch_step: int = 100
    markov: str = "dag"
    qp_iters: int = 60
    qp_rho: float = 0.1
    qp_sigma: float = 1e-6
    qp_alpha: float = 1.6
    qp_warm_start: str = "primal"  # 'primal' | 'full' | 'off'
    qp_backend: str = "xla"  # 'pallas' = the CUDA kernel route
    qp_kkt_bf16: bool = False
    qp_kkt_block: int = 4
    qp_kkt_lowrank: bool = True
    qp_kkt_refine: int = 0
    reset_mult: float = 0.0
    reset_factor: float = 1e-3
    residual_ema: float = 0.98
    dither: float = 0.0
    # failure detection: f_clamp saturates prediction-matrix entries;
    # model_guard holds the last sane model when the new one is non-finite
    # or its estimated spectral radius reaches the bound (0 disables)
    f_clamp: float = 1e5
    model_guard: float = 3.0
    terminal_synthesis: bool = False
    state_bounds: bool = False
    drift_norm: str = "fro"

    @property
    def qp_config(self) -> ADMMConfig:
        return ADMMConfig(
            iters=self.qp_iters,
            rho=self.qp_rho,
            sigma=self.qp_sigma,
            alpha=self.qp_alpha,
            kkt_block=self.qp_kkt_block,
        )


def check_supported(cfg: EngineConfig) -> None:
    """Refuse the options whose paths the port has not reached yet."""
    todo = [
        (cfg.controller != "mpc", "controller='lqr'", "item 15"),
        (cfg.delta_u, "delta_u", "item 10"),
        (cfg.track_lifted, "track_lifted", "item 13"),
        (cfg.terminal_synthesis, "terminal_synthesis", "item 14"),
        (cfg.state_bounds, "state_bounds", "item 12"),
        (cfg.update not in ("rls_sqrt", "off"), f"update={cfg.update!r}",
         "items 10 and 13"),
        (cfg.qp_kkt_refine > 0, "qp_kkt_refine (carried KKT inverse)",
         "L3"),
        (cfg.qp_kkt_bf16, "qp_kkt_bf16", "L3"),
        (cfg.dither > 0.0, "dither", "item 10"),
        (cfg.drift_norm != "fro", f"drift_norm={cfg.drift_norm!r}",
         "item 17"),
        (cfg.integrator != "rk4", f"integrator={cfg.integrator!r}", "L1"),
    ]
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue A, {item})"
            )
    if cfg.qp_warm_start not in ("primal", "full", "off"):
        raise ValueError(f"unknown qp_warm_start {cfg.qp_warm_start!r}")


def _tree_finite(leaves) -> Tensor:
    """Per scenario: all leaves finite, as isfinite(sum |leaf|) in float32
    (``core.py:292-309``). Leaves carry a leading batch axis."""
    total = None
    for leaf in leaves:
        s = leaf.reshape(leaf.shape[0], -1).to(torch.float32).abs().sum(-1)
        total = s if total is None else total + s
    return torch.isfinite(total)


def _spectral_radius_estimate(a: Tensor, iters: int = 12) -> Tensor:
    """|lambda_max(A)| per scenario by power iteration
    (``core.py:318-338``); NaN propagates."""
    n = a.shape[-1]
    v = torch.full(a.shape[:-1], 1.0 / n ** 0.5, dtype=a.dtype, device=a.device)
    nrm = torch.zeros(a.shape[:-2], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        av = (a @ v.unsqueeze(-1)).squeeze(-1)
        nrm = torch.linalg.vector_norm(av, dim=-1)
        v = av / torch.clamp(nrm, min=1e-30)[..., None]
    return nrm


def _select(pred: Tensor, new, old):
    """Per-scenario ``where`` over the leaves of two NamedTuples."""
    out = []
    for a, b in zip(new, old):
        mask = pred.reshape(pred.shape + (1,) * (a.dim() - 1))
        out.append(torch.where(mask, a, b))
    return type(new)(*out)


class ControlDecision(NamedTuple):
    u_applied: Tensor  # (B, m)
    warm_x: Tensor  # (B, N*m) shifted, sanitized primal warm start
    sol: QPSolution
    r_window: Tensor  # (horizon, py)


def make_control_solver(cfg: EngineConfig, ref_fn: Callable[[int], Tensor],
                        m: int):
    """Model -> applied input for a batch of scenarios: condensed QP build
    (``duffing.py:756-800``), box ADMM, projection and warm shift."""
    check_supported(cfg)
    horizon = cfg.horizon
    qp_cfg = cfg.qp_config
    box_solver = make_box_qp_solver(qp_cfg, backend=cfg.qp_backend)

    def control_solve(params: MPCParams, model: LinearModel, z: Tensor,
                      warm_x: Tensor, warm_y: Any, step: int
                      ) -> ControlDecision:
        qbar = weight_bar(params.q_block, horizon)
        rbar = block_diag_repeat(params.r_block, horizon)
        pred = prediction_matrices(model, horizon, params.cy, cfg.markov)
        if cfg.f_clamp > 0.0:
            fc = cfg.f_clamp
            pred = type(pred)(*(
                torch.nan_to_num(f, nan=0.0, posinf=fc, neginf=-fc).clamp(-fc, fc)
                for f in pred
            ))
        r_window = ref_fn(step)  # (horizon, py)
        yr = r_window.reshape(-1)
        n_out = pred.f2.shape[-2]  # N*py
        if cfg.qp_kkt_lowrank and cfg.qp_backend == "xla" and n_out < horizon * m:
            raise NotImplementedError(
                "the output-space (low-rank) KKT for py < m is not ported "
                "yet (ROADMAP queue A, item 12)"
            )
        # per-channel bounds (m,) tiled over the horizon
        lo, hi = (v.repeat((1,) * (v.dim() - 1) + (horizon,))
                  for v in (params.u_min, params.u_max))
        qp = condensed_qp(pred, z, yr, qbar, rbar, lo, hi)
        zeros_x = torch.zeros_like(qp.q)
        x0 = warm_x if cfg.qp_warm_start in ("full", "primal") else zeros_x
        y0 = warm_y if cfg.qp_warm_start == "full" else zeros_x
        sol = box_solver(qp.P, qp.q, qp.l, qp.u, x0, y0)
        # exact projection of the applied move; a non-finite solve applies 0
        first_move = torch.clamp(
            torch.nan_to_num(sol.x[..., :m], nan=0.0, posinf=0.0, neginf=0.0),
            params.u_min, params.u_max,
        )
        # warm start: shift by one move (last move repeated), sanitized
        warm_next = torch.nan_to_num(
            torch.cat([sol.x[..., m:], sol.x[..., -m:]], dim=-1),
            nan=0.0, posinf=0.0, neginf=0.0,
        )
        return ControlDecision(u_applied=first_move, warm_x=warm_next,
                               sol=sol, r_window=r_window)

    return control_solve


def make_estimator_update(dictionary: Dictionary, cfg: EngineConfig):
    """One (z, u, z+, c_target) observation per scenario -> refreshed
    estimator and guarded model. Returns ``(rls, new_model)``."""
    check_supported(cfg)

    def estimator_update(rls, model: LinearModel, z: Tensor, u: Tensor,
                         z_next: Tensor, c_target: Tensor):
        if cfg.update == "off":
            return rls, model
        rls_new = sqrt_rls_update_ab(rls, z, u, z_next, lam=cfg.rls_lambda,
                                     ridge=cfg.rls_ridge)
        rls_new = sqrt_rls_update_c(rls_new, z, c_target, lam=cfg.rls_lambda,
                                    ridge=cfg.rls_ridge)
        new_model = sqrt_rls_model(rls_new, dictionary.nlift)
        if cfg.model_guard > 0.0:
            finite = _tree_finite(new_model)
            radius = _spectral_radius_estimate(new_model.A)
            sane = finite & (radius < cfg.model_guard)
            new_model = _select(sane, new_model, model)
            # the estimator never absorbs non-finite carries
            rls_new = _select(_tree_finite(rls_new), rls_new, rls)
        return rls_new, new_model

    return estimator_update


def change_reset(cfg: EngineConfig, rls, res_ema: Tensor, residual: Tensor):
    """Event-triggered statistic reset on the pre-update one-step residual;
    identity when ``reset_mult`` is 0 (the flagship preset)."""
    if not (cfg.reset_mult > 0.0 and cfg.update == "rls_sqrt"):
        return rls, res_ema
    warmed = res_ema > 0
    trigger = warmed & (residual > cfg.reset_mult * res_ema)
    one = torch.ones_like(residual)
    alpha = torch.where(trigger, cfg.reset_factor * one, one)
    a2, a3 = alpha[:, None, None], alpha.sqrt()[:, None, None]
    rls = rls._replace(K_A=rls.K_A * a2, r_g=rls.r_g * a3,
                       barX=rls.barX * a2, r_q=rls.r_q * a3)
    ema = cfg.residual_ema * res_ema + (1.0 - cfg.residual_ema) * residual
    res_ema = torch.where(trigger, res_ema, ema)
    res_ema = torch.where(warmed, res_ema, residual)
    return rls, res_ema
