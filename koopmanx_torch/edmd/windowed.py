"""Sliding-window online estimator, the refit-from-buffers lane
(counterpart of ``koopmanx/edmd/windowed.py:33-148`` and ``:310-354``).

The last W observations sit in ring buffers; the model is refit from the
window's ridge normal equations, by truncated Newton-Schulz inverses (the
spectral filter the tank family relies on) or, with ``schulz_iters=0``, by
the exact ``spd_inverse``. Estimator math: TF32 stays off
(``device.resolve_device``), as the JAX package pins full precision.

Batching: the engine's state carries a leading scenario axis on every
field, the cursor ``idx`` included, because the model guard may hold one
scenario's ring and cursor back while the others advance (JAX ``select``s
every leaf per scenario under ``vmap``). :func:`window_update` writes out
of place, so a refused update leaves the previous state untouched.
The Woodbury lane (``window_carry='woodbury'``) and compressed ring
storage are ROADMAP queue A, item 11; the engine and ``run`` refuse them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..ops.linalg import spd_inverse
from ..types import LinearModel
from .rls import schulz_inverse

class WindowState(NamedTuple):
    """Ring buffers of the last W observations, with a leading scenario
    axis in the engine (none from :func:`window_init`)."""

    zx: Tensor  # (..., W, N) lifted states
    u: Tensor  # (..., W, m)
    zy: Tensor  # (..., W, N) lifted next states
    x: Tensor  # (..., W, n) output targets
    idx: Tensor  # (...,) int32 write cursor


def window_init(window: int, nlift: int, m: int, n: int,
                dtype: torch.dtype = torch.float32, device=None
                ) -> WindowState:
    """Zero rings for one scenario, stored in the run's dtype."""
    kw = dict(dtype=dtype, device=device)
    return WindowState(
        zx=torch.zeros((window, nlift), **kw),
        u=torch.zeros((window, m), **kw),
        zy=torch.zeros((window, nlift), **kw),
        x=torch.zeros((window, n), **kw),
        idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def window_prefill(state: WindowState, zx: Tensor, u: Tensor, zy: Tensor,
                   x: Tensor) -> WindowState:
    """Fill one scenario's rings with the last (up to W) training
    snapshots, so that the first refit is well posed; the cursor points
    past them."""
    w = state.zx.shape[0]
    take = min(w, zx.shape[0])

    def fill(ring: Tensor, rows: Tensor) -> Tensor:
        out = ring.clone()
        out[:take] = rows[rows.shape[0] - take:].to(ring.dtype)
        return out

    return WindowState(
        zx=fill(state.zx, zx), u=fill(state.u, u), zy=fill(state.zy, zy),
        x=fill(state.x, x),
        idx=torch.full_like(state.idx, take % w),
    )


def window_update(state: WindowState, z: Tensor, u: Tensor, z_next: Tensor,
                  x_target: Tensor) -> WindowState:
    """Write each scenario's observation at its own cursor and advance the
    cursor, out of place: state (B, W, .) with idx (B,), rows (B, .)."""
    w = state.zx.shape[-2]
    rows = torch.arange(state.idx.shape[0], device=state.idx.device)
    at = (rows, state.idx.long())

    def write(ring: Tensor, row: Tensor) -> Tensor:
        # a fresh dense ring: never a view of the caller's (possibly
        # broadcast) one
        out = ring.clone(memory_format=torch.contiguous_format)
        out[at] = row.to(ring.dtype)
        return out

    return WindowState(
        zx=write(state.zx, z), u=write(state.u, u),
        zy=write(state.zy, z_next), x=write(state.x, x_target),
        idx=(state.idx + 1) % w,
    )


def window_model(state: WindowState, nlift: int, ridge: float = 1e-4,
                 schulz_iters: int = 24) -> LinearModel:
    """Refit (A, B, C) from the window's ridge normal equations:
    ``[A B] = Zy' V (V'V + ridge I)^-1``, ``C = X' Zx (Zx'Zx + ridge I)^-1``,
    the inverses by ``schulz_iters`` Newton-Schulz steps, or exact
    (``spd_inverse``) with ``schulz_iters=0``."""
    zx, zy, x = state.zx, state.zy, state.x
    v = torch.cat([zx, state.u], dim=-1)  # (..., W, N+m)
    vt, zxt = v.transpose(-1, -2), zx.transpose(-1, -2)
    eye = lambda k: torch.eye(k, dtype=v.dtype, device=v.device)
    g = vt @ v + ridge * eye(v.shape[-1])
    gz = zxt @ zx + ridge * eye(nlift)
    if schulz_iters:
        g_inv = schulz_inverse(g, schulz_iters)
        gz_inv = schulz_inverse(gz, schulz_iters)
    else:
        g_inv = spd_inverse(g)
        gz_inv = spd_inverse(gz)
    k_ext = (g_inv @ (vt @ zy)).transpose(-1, -2)
    c = (gz_inv @ (zxt @ x)).transpose(-1, -2)
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:], C=c)
