"""Plants with time-varying parameters (counterpart of
``koopmanx/systems/base.py``).

A plant is either a continuous vector field ``f(t, x, u, theta)``
integrated by RK4, or an exact discrete map ``step_map(x, u, theta)``
(``discrete=True``, the cascaded tanks), optionally followed by a state
clamp. Both work over a batch of states ``x: (B, n)``, ``u: (B, m)`` and a
parameter tuple whose leaves are scalars or ``(B,)`` tensors. Where JAX
used ``vmap`` the batch axis is written out; the step index is a Python
int, so the parameter switch is a plain branch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import Tensor

from ..utils import profiling

VectorField = Callable[[float, Tensor, Tensor, Any], Tensor]
StepMap = Callable[[Tensor, Tensor, Any], Tensor]


@dataclasses.dataclass(frozen=True)
class System:
    """A plant: a continuous vector field ``f`` (integrated by RK4) or an
    exact discrete map ``step_map`` (``discrete=True``); ``clamp`` is
    applied to every next state (the tanks: x >= 0); ``x_init`` is the
    default initial state on every channel."""

    name: str
    n: int
    m: int
    f: Optional[VectorField] = None
    step_map: Optional[StepMap] = None
    discrete: bool = False
    theta0: Any = None  # nominal parameters
    theta1: Any = None  # post-switch parameters
    clamp: Optional[Callable[[Tensor], Tensor]] = None
    x_init: float = -2.0  # duffing.py:650


def make_switch_schedule(theta0: Any, theta1: Any, switch_step: int):
    """``theta(step) = theta1 if step > switch_step else theta0`` (strictly
    greater, the reference's ``if i > 100``; ``systems/base.py:54-69``)."""

    def schedule(step: int) -> Any:
        return theta1 if step > switch_step else theta0

    return schedule


def make_constant_schedule(theta: Any):
    """``theta(step) = theta`` for every step: a plant that never
    switches (``systems/base.py:72-77``)."""

    def schedule(step: int) -> Any:
        del step
        return theta

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


def rk4_step_k1k4(f: VectorField, h: float) -> StepMap:
    """The MATLAB reference's RK4 variant, its k4 stage (sic) evaluated at
    ``x + h*k1`` (``systems/base.py:95-109``;
    ``Revise_2/Koopman_update.m:21-25``)."""

    def step(x: Tensor, u: Tensor, theta: Any) -> Tensor:
        t = 0.0
        k1 = f(t, x, u, theta)
        k2 = f(t + h / 2.0, x + 0.5 * h * k1, u, theta)
        k3 = f(t + h / 2.0, x + 0.5 * h * k2, u, theta)
        k4 = f(t + h, x + h * k1, u, theta)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


def make_step(system: System, h: float, integrator: str = "rk4") -> StepMap:
    """The one-step plant map ``x+ = F(x, u, theta)``, clamped where the
    system says (``systems/base.py:112-129``): ``integrator`` 'rk4' or
    'rk4_matlab'. A discrete plant ignores ``h`` and ``integrator``."""
    if system.discrete:
        base = system.step_map
    elif integrator == "rk4":
        base = rk4_step(system.f, h)
    elif integrator == "rk4_matlab":
        base = rk4_step_k1k4(system.f, h)
    else:
        raise ValueError(f"unknown integrator {integrator!r}")
    clamp = system.clamp

    def step(x: Tensor, u: Tensor, theta: Any) -> Tensor:
        with profiling.span("kx.plant"):
            x_next = base(x, u, theta)
            return x_next if clamp is None else clamp(x_next)

    return step


def as_params(theta: Any, dtype: torch.dtype, device: torch.device) -> Any:
    """Cast every leaf of a parameter NamedTuple to a tensor."""
    return type(theta)(
        *(torch.as_tensor(v, dtype=dtype, device=device) for v in theta)
    )
