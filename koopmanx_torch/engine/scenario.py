"""Scenario batches (counterpart of ``koopmanx/engine/scenario.py:26-81``).

A scenario is an initial state and per-scenario plant parameters before
and after the switch. Draws come from an explicit CPU ``torch.Generator``
and the batch is then moved to the run's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch import Tensor

from ..device import DeviceLike, resolve_device
from ..systems.base import System
from ..systems.data import uniform


class ScenarioBatch(NamedTuple):
    x0: Tensor  # (B, n)
    theta0: Any  # parameter NamedTuple, leaves (B,)
    theta1: Any


def perturb_theta(gen: torch.Generator, theta: Any, batch: int,
                  rel_scale: float, dtype: torch.dtype) -> Any:
    """``theta * (1 + U[-rel_scale, rel_scale])`` per leaf and scenario."""
    leaves = []
    for leaf in theta:
        noise = uniform(gen, (batch,), -rel_scale, rel_scale, dtype)
        leaves.append(torch.as_tensor(leaf, dtype=dtype) * (1.0 + noise))
    return type(theta)(*leaves)


def sample_scenarios(
    system: System,
    gen: torch.Generator,
    batch: int,
    x0_range: Tuple[float, float] = (-2.0, 2.0),
    param_scale: float = 0.2,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> ScenarioBatch:
    """x0 ~ U[x0_range]^n and per-scenario nominal and switched parameters,
    each perturbed by ``param_scale``."""
    dev = resolve_device(device)
    x0 = uniform(gen, (batch, system.n), *x0_range, dtype)
    theta0 = perturb_theta(gen, system.theta0, batch, param_scale, dtype)
    theta1 = perturb_theta(gen, system.theta1, batch, param_scale, dtype)
    move = lambda th: type(th)(*(v.to(dev) for v in th))
    return ScenarioBatch(x0=x0.to(dev), theta0=move(theta0),
                         theta1=move(theta1))


def replicate_scenario(x0, theta0: Any, theta1: Any, batch: int,
                       dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None) -> ScenarioBatch:
    """One scenario tiled to a batch of ``batch`` (for throughput runs of
    one config at scale), every leaf cast to ``dtype`` on ``device``
    (None means CUDA)."""
    dev = resolve_device(device)

    def rep(v):
        v = torch.as_tensor(v, dtype=dtype, device=dev)
        return v.expand((batch,) + v.shape)

    return ScenarioBatch(x0=rep(x0), theta0=type(theta0)(*map(rep, theta0)),
                         theta1=type(theta1)(*map(rep, theta1)))
