"""Plants with time-varying parameters (counterpart of
``koopmanx/systems/base.py``).

A plant's vector field is ``f(t, x, u, theta)`` over a batch of states
``x: (B, n)``, ``u: (B, m)`` and a parameter tuple whose leaves are
scalars or ``(B,)`` tensors. Where JAX used ``vmap`` the batch axis is
written out; the step index is a Python int, so the parameter switch is a
plain branch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import Tensor

VectorField = Callable[[float, Tensor, Tensor, Any], Tensor]
StepMap = Callable[[Tensor, Tensor, Any], Tensor]


@dataclasses.dataclass(frozen=True)
class System:
    """A continuous plant integrated by RK4 (the port has no discrete
    plants yet)."""

    name: str
    n: int
    m: int
    f: VectorField
    theta0: Any = None  # nominal parameters
    theta1: Any = None  # post-switch parameters


def make_switch_schedule(theta0: Any, theta1: Any, switch_step: int):
    """``theta(step) = theta1 if step > switch_step else theta0`` (strictly
    greater, the reference's ``if i > 100``; ``systems/base.py:54-69``)."""

    def schedule(step: int) -> Any:
        return theta1 if step > switch_step else theta0

    return schedule


def rk4_step(f: VectorField, h: float) -> StepMap:
    """Classic RK4, k4 evaluated at ``x + h*k3`` (``systems/base.py:80-92``)."""

    def step(x: Tensor, u: Tensor, theta: Any) -> Tensor:
        t = 0.0
        k1 = f(t, x, u, theta)
        k2 = f(t + h / 2.0, x + 0.5 * h * k1, u, theta)
        k3 = f(t + h / 2.0, x + 0.5 * h * k2, u, theta)
        k4 = f(t + h, x + h * k3, u, theta)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


def make_step(system: System, h: float, integrator: str = "rk4") -> StepMap:
    """The one-step plant map ``x+ = F(x, u, theta)``
    (``systems/base.py:112-129``)."""
    if integrator != "rk4":
        raise NotImplementedError(
            f"integrator {integrator!r} is not ported yet (ROADMAP queue A, "
            "L1: rk4_step_k1k4)"
        )
    return rk4_step(system.f, h)


def as_params(theta: Any, dtype: torch.dtype, device: torch.device) -> Any:
    """Cast every leaf of a parameter NamedTuple to a tensor."""
    return type(theta)(
        *(torch.as_tensor(v, dtype=dtype, device=device) for v in theta)
    )
