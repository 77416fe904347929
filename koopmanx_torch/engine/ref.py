"""Reference-signal generators (counterpart of ``koopmanx/engine/ref.py``).

Each factory returns ``ref_fn(step) -> (horizon, py)``: the receding
window r_k .. r_{k+N-1} for the MPC cost, with ``step`` a Python int. The
window's index is ``j = step + arange(horizon)``, cast to the run's dtype
where the JAX package casts it. ``step`` may also be a ``(B,)`` int64
tensor of per-plant steps (the serving fleet's episode clocks, which JAX
``vmap``-ed); the time-varying signals then give one window per plant,
``(B, horizon, py)``, and the constant ones their shared window.
"""
from __future__ import annotations

from typing import Callable, Union

import torch
from torch import Tensor

from ..lifts.base import Dictionary

Step = Union[int, Tensor]  # a step index, or (B,) per-plant steps
RefFn = Callable[[Step], Tensor]


def _window(step: Step, horizon: int, device) -> Tensor:
    """(horizon,) indices, or (B, horizon) for per-plant steps."""
    if isinstance(step, Tensor):
        return step.to(device)[:, None] + torch.arange(horizon, device=device)
    return step + torch.arange(horizon, device=device)


def _first_channel(r1: Tensor, py: int) -> Tensor:
    """(..., horizon) -> (..., horizon, py), zero but for the first
    channel."""
    out = torch.zeros(r1.shape + (py,), dtype=r1.dtype, device=r1.device)
    out[..., 0] = r1
    return out


def constant(value, horizon: int, py: int = 1,
             dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r = const (r = 1 for Duffing, duffing.py:748)."""
    v = torch.as_tensor(value, dtype=dtype, device=device).expand(py)
    window = v.expand(horizon, py)

    def ref_fn(step: Step) -> Tensor:
        del step
        return window

    return ref_fn


def sine(amp, omega, horizon: int, py: int = 1, offset=0.0,
         dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r_j = amp*sin(omega*j) + offset on the first channel
    (duffing.py:744: ``sin(0.01 j)``)."""

    def ref_fn(step: Step) -> Tensor:
        j = _window(step, horizon, device).to(dtype)
        return _first_channel(amp * torch.sin(omega * j) + offset, py)

    return ref_fn


def cos_sin_mix(a, wa, b, wb, horizon: int, py: int = 1,
                dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r_j = a*cos(wa*j) + b*sin(wb*j) (duffing.py:755)."""

    def ref_fn(step: Step) -> Tensor:
        j = _window(step, horizon, device).to(dtype)
        return _first_channel(a * torch.cos(wa * j) + b * torch.sin(wb * j),
                              py)

    return ref_fn


def square(amp, period: int, horizon: int, py: int = 1,
           dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r = amp * (-1)^ceil(j/period) square wave (duffing.py:745), from the
    integer window as in the JAX package."""

    def ref_fn(step: Step) -> Tensor:
        j = _window(step, horizon, device)
        sign = 1.0 - 2.0 * (torch.ceil(j / period) % 2)
        return _first_channel(amp * sign.to(dtype), py)

    return ref_fn


def chirp(amp, horizon: int, py: int = 1, offset=0.7,
          dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r_j = amp*sin(j/(20+0.01j)) + offset (duffing.py:742, commented out
    there)."""

    def ref_fn(step: Step) -> Tensor:
        j = _window(step, horizon, device).to(dtype)
        return _first_channel(amp * torch.sin(j / (20.0 + 0.01 * j)) + offset,
                              py)

    return ref_fn


def encoded(base: RefFn, dictionary: Dictionary, n: int) -> RefFn:
    """Lifted-space reference: each horizon step of the state reference
    ``base(step)`` (horizon, n) through the dictionary the engine lifts
    with (``vanderpol.py:668-675``), giving (horizon, nlift)."""
    del n  # the JAX signature's; the dictionary knows its input width

    def ref_fn(step: Step) -> Tensor:
        return dictionary(base(step))

    return ref_fn


def constant_state(values, horizon: int, dtype: torch.dtype = torch.float32,
                   device=None) -> RefFn:
    """Full-state constant reference, e.g. VDP's [-1, 0]
    (VDP_Revise_2/Koopman_update_Tracking_Lift.m:111)."""
    v = torch.as_tensor(values, dtype=dtype, device=device)
    window = v.expand(horizon, v.shape[-1])

    def ref_fn(step: Step) -> Tensor:
        del step
        return window

    return ref_fn
