"""Plant library (counterpart of ``koopmanx/systems/library.py:18-40``).

The slice ports the Duffing oscillator; the other plants of the JAX
registry raise ``NotImplementedError`` naming the ROADMAP item.
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

REGISTRY = {DUFFING.name: DUFFING}

# plants of the JAX registry that later slices port (ROADMAP queue A)
_NOT_PORTED = {
    "vanderpol": "item 13 (VDP and the remaining estimators)",
    "tank": "item 10 (windowed estimator, tank family)",
    "tank3": "item 10 (windowed estimator, tank family)",
    "tank_mimo": "item 12 (tank_mimo)",
    "pendulum": "item 10 (windowed estimator, tank family)",
    "toy1d": "item 14 (terminal synthesis, Revise_2 presets)",
    "approach3": "item 18 (training)",
}


def get_system(name: str) -> System:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"system {name!r} is not ported yet: ROADMAP queue A, "
            f"{_NOT_PORTED[name]}"
        )
    raise KeyError(f"unknown system {name!r}; available: {sorted(REGISTRY)}")
