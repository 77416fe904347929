"""Local linearization of a plant (counterpart of
``koopmanx/systems/linearize.py``): the exact Jacobians of its vector
field or one-step map at an operating point, the model of the
local-linearization MPC baseline (``duffing.py:691-706``;
``Revise_2/Koopman_update.m:169-177``).

Where the JAX package takes ``jax.jacfwd`` of one point's map under
``vmap``, each function here takes a batch of points, ``x (..., n)``,
``u (..., m)``, and the plant parameters as scalars or ``(...)`` tensors,
and runs one forward-mode pass (``torch.func.jvp``) of the batched map
per input direction: n + m passes, each giving one column of A or B for
every point at once (the scenarios of a batch do not mix). A clamped
plant's derivative at the kink is ``torch.maximum``'s, 0.5 at a tie, as
``jnp.maximum``'s (``systems/library.py::_clamp_nonneg``).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import Tensor
from torch.func import jvp

from ..types import LinearModel
from .base import System, make_step


def _mv(a: Tensor, v: Tensor) -> Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _jacobian(fn: Callable[[Tensor], Tensor], at: Tensor) -> Tensor:
    """d fn / d at, (..., out, k), one jvp per direction of the last axis
    of ``at``. Forward-mode AD runs outside inference mode, on a copy of
    ``at``: under ``torch.inference_mode()`` some torch releases (2.11)
    give ``jvp`` zero tangents without an error."""
    with torch.inference_mode(False):
        at = at.clone()
        cols = []
        for i in range(at.shape[-1]):
            tangent = torch.zeros_like(at)
            tangent[..., i] = 1.0
            cols.append(jvp(fn, (at,), (tangent,))[1])
        return torch.stack(cols, dim=-1)


def linearize_continuous(system: System, x: Tensor, u: Tensor,
                         theta: Any = None) -> Tuple[Tensor, Tensor]:
    """(A_c, B_c) = (df/dx, df/du) of the continuous vector field at each
    (x, u) (``linearize.py:25-35``)."""
    if system.f is None:
        raise ValueError("system has no continuous vector field")
    theta = system.theta0 if theta is None else theta
    a_c = _jacobian(lambda xx: system.f(0.0, xx, u, theta), x)
    b_c = _jacobian(lambda uu: system.f(0.0, x, uu, theta), u)
    return a_c, b_c


def linearize_discrete(system: System, x: Tensor, u: Tensor,
                       h: float = 0.05, theta: Any = None,
                       integrator: str = "rk4") -> LinearModel:
    """The exact Jacobian of the one-step map x+ = F(x, u) at each (x, u)
    (``linearize.py:38-56``): A = dF/dx, B = dF/du, C = I."""
    theta = system.theta0 if theta is None else theta
    step = make_step(system, h, integrator)
    a = _jacobian(lambda xx: step(xx, u, theta), x)
    b = _jacobian(lambda uu: step(x, uu, theta), u)
    c = torch.eye(system.n, dtype=x.dtype, device=x.device)
    return LinearModel(A=a, B=b, C=c.expand(x.shape[:-1] + c.shape))


def affine_residual(system: System, x: Tensor, u: Tensor,
                    model: LinearModel, h: float = 0.05, theta: Any = None,
                    integrator: str = "rk4") -> Tensor:
    """d = F(x0, u0) - A x0 - B u0, so that the local model predicts
    x+ = A x + B u + d exactly at the linearization point
    (``linearize.py:59-72``)."""
    theta = system.theta0 if theta is None else theta
    step = make_step(system, h, integrator)
    return step(x, u, theta) - _mv(model.A, x) - _mv(model.B, u)


def batch_linearize_discrete(system: System, xs: Tensor, us: Tensor,
                             h: float = 0.05, theta: Any = None,
                             integrator: str = "rk4") -> LinearModel:
    """:func:`linearize_discrete` over a batch of operating points
    (``linearize.py:75-78``); every function here is batched already."""
    return linearize_discrete(system, xs, us, h, theta, integrator)
