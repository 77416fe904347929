"""Single-shooting MPC cost and its projected-gradient solver
(counterpart of ``koopmanx/control/shooting.py``).

The reference's solver target (``duffing.py:540-581``): roll
z+ = [A B][z; u] + d over Np steps (Nc decision moves, the tail holding
the last move) and charge ``100 sum ||y - r||^2 + 1e-4 sum u^2`` with
y = C z, or y = z against an encoded reference under lifted tracking
(``vanderpol.py:456-475``). The engine solves the equivalent condensed QP;
this form serves parity checks and gradient solves of the same objective.

Batched over a leading scenario axis where the JAX package was
``vmap``-ed: ``u_seq (B, Nc, m)``, model leaves ``(B, ...)``,
``z0 (B, nz)``, ``r (Np, py)`` shared or ``(B, Np, py)``; the scan over
the horizon is a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor
from torch.func import grad

from ..types import LinearModel


def _mv(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def shooting_cost(u_seq: Tensor, model: LinearModel, z0: Tensor, r: Tensor,
                  np_horizon: int, track_lifted: bool = False,
                  q_weight: float = 100.0, r_weight: float = 1e-4,
                  d: Optional[Tensor] = None) -> Tensor:
    """The reference's cost per scenario, (B,) (``shooting.py:27-53``)."""
    nc = u_seq.shape[-2]
    z = z0
    errs = []
    for k in range(np_horizon):
        u = u_seq[..., min(k, nc - 1), :]  # the tail holds the last move
        z = _mv(model.A, z) + _mv(model.B, u)
        if d is not None:
            z = z + d
        y = z if track_lifted else _mv(model.C, z)
        err = y - r[..., k, :]
        errs.append((err * err).sum(-1))
    return (q_weight * torch.stack(errs, dim=-1).sum(-1)
            + r_weight * (u_seq * u_seq).sum((-2, -1)))


class PGDConfig(NamedTuple):
    iters: int = 200
    lr: float = 0.05
    momentum: float = 0.9  # Nesterov


def solve_shooting_pgd(model: LinearModel, z0: Tensor, r: Tensor, nc: int,
                       np_horizon: int, lo, hi, cfg: PGDConfig = PGDConfig(),
                       track_lifted: bool = False, q_weight: float = 100.0,
                       r_weight: float = 1e-4,
                       u_init: Optional[Tensor] = None) -> Tensor:
    """Projected Nesterov gradient descent on the shooting cost within
    [lo, hi] (``shooting.py:62-94``): ``cfg.iters`` steps of
    g = grad(u + mu v), v <- mu v - lr g, u <- clip(u + v, lo, hi),
    v <- the step taken. The gradient of the summed batch cost is each
    scenario's own (they do not mix). Returns u (B, nc, m). Autograd runs
    on copies of the inputs, so a caller under ``torch.inference_mode()``
    may call it."""
    m = model.B.shape[-1]
    with torch.inference_mode(False), torch.enable_grad():
        model = LinearModel(*(t.clone() for t in model))
        z0, r = z0.clone(), r.clone()
        lo, hi = (torch.as_tensor(v, dtype=z0.dtype, device=z0.device).clone()
                  for v in (lo, hi))
        u = (torch.zeros(z0.shape[:-1] + (nc, m), dtype=z0.dtype,
                         device=z0.device)
             if u_init is None else u_init.clone())
        grad_fn = grad(lambda uu: shooting_cost(
            uu, model, z0, r, np_horizon, track_lifted, q_weight,
            r_weight).sum())
        v = torch.zeros_like(u)
        for _ in range(cfg.iters):
            g = grad_fn(u + cfg.momentum * v)
            v_new = cfg.momentum * v - cfg.lr * g
            u_new = torch.clamp(u + v_new, lo, hi)
            u, v = u_new, u_new - u
    return u
