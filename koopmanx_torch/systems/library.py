"""Plant library (counterpart of ``koopmanx/systems/library.py``).

The port has the Duffing oscillator, the Van der Pol oscillator, the
cascaded tanks (two and three stages, and the two-pump tank_mimo: exact
discrete maps clamped at x >= 0), the damped pendulum and the one-state
toy plant of the Revise_2 experiments and the approach3 plant of the
KMAE training file: every plant of the JAX registry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .base import System


class DuffingParams(NamedTuple):
    """x1' = x2 ; x2' = d*x2 + k1*x1 + k3*x1^3 + u."""

    d: Tensor
    k1: Tensor
    k3: Tensor


def _duffing_f(t, x: Tensor, u: Tensor, th: DuffingParams) -> Tensor:
    del t
    x1, x2 = x[..., 0], x[..., 1]
    dx2 = th.d * x2 + th.k1 * x1 + th.k3 * (x1 * x1 * x1) + u[..., 0]
    return torch.stack([x2, dx2], dim=-1)


# nominal: duffing.py:255 / data_generate.py:23; switched: duffing.py:802-803
DUFFING = System(
    name="duffing",
    n=2,
    m=1,
    f=_duffing_f,
    theta0=DuffingParams(d=-0.5, k1=1.0, k3=-1.0),
    theta1=DuffingParams(d=-5.0, k1=2.0, k3=-0.5),
)


class VdpParams(NamedTuple):
    """x1' = a*x2 ; x2' = b*x2 + c*x1^2*x2 + d*x1 + u."""

    a: Tensor
    b: Tensor
    c: Tensor
    d: Tensor


def _vdp_f(t, x: Tensor, u: Tensor, th: VdpParams) -> Tensor:
    del t
    x1, x2 = x[..., 0], x[..., 1]
    dx2 = th.b * x2 + th.c * (x1 * x1) * x2 + th.d * x1 + u[..., 0]
    return torch.stack([th.a * x2, dx2], dim=-1)


# nominal: vanderpol.py:252; switched: vanderpol.py:714 (the switched
# field's first row drops the factor 2, x1' = x2, as the reference does)
VANDERPOL = System(
    name="vanderpol",
    n=2,
    m=1,
    f=_vdp_f,
    theta0=VdpParams(a=2.0, b=2.0, c=-10.0, d=-0.8),
    theta1=VdpParams(a=1.0, b=-3.0, c=-10.0, d=-3.0),
)


# a 0-dim host zero: a scalar operand on any device and dtype
_ZERO = torch.tensor(0.0)


def _clamp_nonneg(x: Tensor) -> Tensor:
    """x >= 0, NaN kept (``jnp.maximum(x, 0.0)``; Tank_System.m:40,45,211).
    ``torch.maximum``, not ``clamp``: at a tie its derivative is 0.5, as
    ``jnp.maximum``'s, so the Jacobians of ``systems.linearize`` agree
    with the JAX package's on the kink too."""
    return torch.maximum(x, _ZERO)


def _sqrt_level(x: Tensor) -> Tensor:
    return torch.sqrt(_clamp_nonneg(x))


class TankParams(NamedTuple):
    """Exact discrete cascaded-tank map (Tank_System.m:9-10):
    x1+ = x1 - c1*sqrt(x1) + c2*u ; x2+ = x2 + c3*sqrt(x1) - c4*sqrt(x2)."""

    c1: Tensor
    c2: Tensor
    c3: Tensor
    c4: Tensor


def _tank_step(x: Tensor, u: Tensor, th: TankParams) -> Tensor:
    s1, s2 = _sqrt_level(x[..., 0]), _sqrt_level(x[..., 1])
    return torch.stack([x[..., 0] - th.c1 * s1 + th.c2 * u[..., 0],
                        x[..., 1] + th.c3 * s1 - th.c4 * s2], dim=-1)


TANK = System(
    name="tank",
    n=2,
    m=1,
    step_map=_tank_step,
    discrete=True,
    theta0=TankParams(c1=0.5, c2=0.4, c3=0.2, c4=0.3),
    theta1=TankParams(c1=0.53, c2=0.3, c3=0.1, c4=0.35),  # Tank_System.m:195-196
    clamp=_clamp_nonneg,
    x_init=0.0,  # Tank_System.m:125
)


class Tank3Params(NamedTuple):
    """Three-tank cascade: the two-tank map extended by one stage,
    x3+ = x3 + c5*sqrt(x2) - c6*sqrt(x3)."""

    c1: Tensor
    c2: Tensor
    c3: Tensor
    c4: Tensor
    c5: Tensor
    c6: Tensor


def _tank3_step(x: Tensor, u: Tensor, th: Tank3Params) -> Tensor:
    s1, s2, s3 = (_sqrt_level(x[..., i]) for i in range(3))
    return torch.stack([x[..., 0] - th.c1 * s1 + th.c2 * u[..., 0],
                        x[..., 1] + th.c3 * s1 - th.c4 * s2,
                        x[..., 2] + th.c5 * s2 - th.c6 * s3], dim=-1)


TANK3 = System(
    name="tank3",
    n=3,
    m=1,
    step_map=_tank3_step,
    discrete=True,
    theta0=Tank3Params(c1=0.5, c2=0.4, c3=0.2, c4=0.3, c5=0.2, c6=0.25),
    theta1=Tank3Params(c1=0.53, c2=0.3, c3=0.1, c4=0.35, c5=0.22, c6=0.27),
    clamp=_clamp_nonneg,
    x_init=0.0,  # Tank_System.m:125
)


class TankMimoParams(NamedTuple):
    """Two-pump cascaded tanks, the registry's one multi-input plant
    (m = 2): the two-tank map with a second pump feeding tank 2,
    x1+ = x1 - c1*sqrt(x1) + c2*u1 ;
    x2+ = x2 + c3*sqrt(x1) - c4*sqrt(x2) + c5*u2."""

    c1: Tensor
    c2: Tensor
    c3: Tensor
    c4: Tensor
    c5: Tensor


def _tank_mimo_step(x: Tensor, u: Tensor, th: TankMimoParams) -> Tensor:
    s1, s2 = _sqrt_level(x[..., 0]), _sqrt_level(x[..., 1])
    return torch.stack([x[..., 0] - th.c1 * s1 + th.c2 * u[..., 0],
                        x[..., 1] + th.c3 * s1 - th.c4 * s2
                        + th.c5 * u[..., 1]], dim=-1)


# x_init stays the default -2.0: the JAX package starts only tank and
# tank3 at 0 (koopmanx/run.py:396-399)
TANK_MIMO = System(
    name="tank_mimo",
    n=2,
    m=2,
    step_map=_tank_mimo_step,
    discrete=True,
    theta0=TankMimoParams(c1=0.5, c2=0.4, c3=0.2, c4=0.3, c5=0.25),
    theta1=TankMimoParams(c1=0.53, c2=0.3, c3=0.1, c4=0.35, c5=0.2),
    clamp=_clamp_nonneg,
)


class PendulumParams(NamedTuple):
    """x1' = x2 ; x2' = -a*sin(x1) - b*x2 + k*u (a = g/l, b the damping
    rate, k the torque gain; the switch grows the payload mass 50 %)."""

    a: Tensor
    b: Tensor
    k: Tensor


def _pendulum_f(t, x: Tensor, u: Tensor, th: PendulumParams) -> Tensor:
    del t
    x1, x2 = x[..., 0], x[..., 1]
    dx2 = -th.a * torch.sin(x1) - th.b * x2 + th.k * u[..., 0]
    return torch.stack([x2, dx2], dim=-1)


PENDULUM = System(
    name="pendulum",
    n=2,
    m=1,
    f=_pendulum_f,
    theta0=PendulumParams(a=4.0, b=0.5, k=1.0),
    theta1=PendulumParams(a=4.0, b=1.0 / 3.0, k=2.0 / 3.0),
)

class Toy1dParams(NamedTuple):
    """x' = a2 x^2 + a3 x^3 + a1 x + u
    (One_Dimensional_Toy_Example_Continuous_System.m:4)."""

    a1: Tensor
    a2: Tensor
    a3: Tensor


def _toy1d_f(t, x: Tensor, u: Tensor, th: Toy1dParams) -> Tensor:
    del t
    x1 = x[..., 0]
    return (th.a2 * (x1 * x1) + th.a3 * (x1 * x1 * x1) + th.a1 * x1
            + u[..., 0]).unsqueeze(-1)


# the one-state toy plant; the reference has no switch (theta1 = theta0)
TOY1D = System(
    name="toy1d",
    n=1,
    m=1,
    f=_toy1d_f,
    theta0=Toy1dParams(a1=0.4, a2=0.2, a3=-0.3),
    theta1=Toy1dParams(a1=0.4, a2=0.2, a3=-0.3),
)



class Approach3Params(NamedTuple):
    """x1' = a x1 ; x2' = b x2 + x1^4 - 2 x1^2 + u
    (DeepLearning_KoopmanControl_Approach3.py:91)."""

    a: Tensor
    b: Tensor


def _approach3_f(t, x: Tensor, u: Tensor, th: Approach3Params) -> Tensor:
    del t
    x1, x2 = x[..., 0], x[..., 1]
    x1_sq = x1 * x1
    dx2 = th.b * x2 + x1_sq * x1_sq - 2.0 * x1_sq + u[..., 0]
    return torch.stack([th.a * x1, dx2], dim=-1)


# the KMAE training file's plant; no switch (theta1 = theta0)
APPROACH3 = System(
    name="approach3",
    n=2,
    m=1,
    f=_approach3_f,
    theta0=Approach3Params(a=-0.1, b=-1.0),
    theta1=Approach3Params(a=-0.1, b=-1.0),
)

REGISTRY = {s.name: s for s in (DUFFING, VANDERPOL, TANK, TANK3, TANK_MIMO,
                                PENDULUM, TOY1D, APPROACH3)}


def get_system(name: str) -> System:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown system {name!r}; available: {sorted(REGISTRY)}") from None
