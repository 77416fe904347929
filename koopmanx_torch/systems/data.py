"""Data collection: batched random-excitation rollouts (counterpart of
``koopmanx/systems/data.py:55-109``), and the reference's column-major
snapshot layout.

Snapshots are row-major ``(S, n)`` in trajectory-major order, as in the
JAX package. Random draws come from an explicit ``torch.Generator`` on the
CPU, so a seed gives the same data on every device (not the same numbers
as ``jax.random``; tests hand both packages the same numpy inputs).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch import Tensor

from .base import System, as_params, make_step


class Snapshots(NamedTuple):
    """Trajectory-major snapshot arrays: X, Y are (S, n); U is (S, m)."""

    x: Tensor
    y: Tensor
    u: Tensor


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            dtype: torch.dtype) -> Tensor:
    """U[lo, hi) draws on the generator's (CPU) device."""
    return torch.rand(shape, generator=gen, dtype=dtype) * (hi - lo) + lo


def rollout(step_fn, x0: Tensor, u_seq: Tensor, theta: Any
            ) -> Tuple[Tensor, Tensor]:
    """Roll a batch of trajectories: x0 (B, n), u_seq (B, T, m) ->
    (X, Y) of shape (B, T, n) with X[:, t] = x_t, Y[:, t] = x_{t+1}."""
    xs, ys = [], []
    x = x0
    for t in range(u_seq.shape[1]):
        x_next = step_fn(x, u_seq[:, t], theta)
        xs.append(x)
        ys.append(x_next)
        x = x_next
    return torch.stack(xs, dim=1), torch.stack(ys, dim=1)


def collect(
    system: System,
    gen: torch.Generator,
    n_step: int = 100,
    n_traj: int = 100,
    h: float = 0.05,
    u_range: Tuple[float, float] = (-2.0, 2.0),
    x0_range: Tuple[float, float] = (-2.0, 2.0),
    integrator: str = "rk4",
    clamp_x0: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Snapshots:
    """``u ~ U[u_range]`` i.i.d. per step, ``x0 ~ U[x0_range]``; runs on
    the CPU (one-time setup, see :func:`koopmanx_torch.run.build_pipeline`)."""
    theta = as_params(system.theta0, dtype, torch.device("cpu"))
    step_fn = make_step(system, h, integrator)
    u_seq = uniform(gen, (n_traj, n_step, system.m), *u_range, dtype)
    x0 = uniform(gen, (n_traj, system.n), *x0_range, dtype)
    if clamp_x0:
        x0 = torch.clamp(x0, min=0.0)
    xs, ys = rollout(step_fn, x0, u_seq, theta)
    return Snapshots(
        x=xs.reshape(-1, system.n),
        y=ys.reshape(-1, system.n),
        u=u_seq.reshape(-1, system.m),
    )


def from_reference_layout(x, y, u) -> Snapshots:
    """Reference-style column-major snapshot matrices X, Y (n, S) and U
    (m, S) or (S,) as row-major :class:`Snapshots` (for fixtures written
    by the reference's own scripts)."""
    t = lambda a: torch.as_tensor(a)
    u = t(u)
    return Snapshots(x=t(x).T, y=t(y).T,
                     u=(u[None] if u.dim() == 1 else u).T)
