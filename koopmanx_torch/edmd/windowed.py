"""Sliding-window online estimator (counterpart of
``koopmanx/edmd/windowed.py``): the refit-from-buffers lane and the
Woodbury lane.

The last W observations sit in ring buffers. The default lane refits the
model from the window's ridge normal equations, by truncated Newton-Schulz
inverses (the spectral filter the tank family relies on) or, with
``schulz_iters=0``, by the exact ``spd_inverse``. The Woodbury lane
(``window_carry='woodbury'``) carries the window's ridge Grams, their
inverses and the cross-Grams, and moves them by rank 2 each step
(Sherman-Morrison, then a Newton-Schulz polish against the exact carried
Gram), so the model is fresh every step without a refit. The rings may be
stored compressed (bf16/f16): the refit and the carried statistics stay in
float32 (float64 for a float64 ring), and the Woodbury lane quantizes each
incoming row to the storage dtype before it uses it, so a row evicted W
steps later is bit-identical to the one added. Estimator math: TF32 stays
off (``device.resolve_device``), as the JAX package pins full precision.

Batching: the engine's state carries a leading scenario axis on every
field, the cursor ``idx`` included, because the model guard may hold one
scenario's state back while the others advance (JAX ``select``s every leaf
per scenario under ``vmap``). The updates write out of place, so a refused
update leaves the previous state untouched.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from ..ops.linalg import spd_inverse
from ..types import LinearModel
from .rls import schulz_inverse


class WindowState(NamedTuple):
    """Ring buffers of the last W observations, with a leading scenario
    axis in the engine (none from :func:`window_init`). The six trailing
    fields are the Woodbury lane's carried statistics, ``None`` in the
    refit-from-buffers lane: ``g = V'V + ridge I`` and ``gz = Zx'Zx +
    ridge I`` with V = [Zx U], their inverses, ``mg = V'Zy`` and
    ``mc = Zx'X``."""

    zx: Tensor  # (..., W, N) lifted states
    u: Tensor  # (..., W, m)
    zy: Tensor  # (..., W, N) lifted next states
    x: Tensor  # (..., W, n) output targets
    idx: Tensor  # (...,) int32 write cursor
    g: Optional[Tensor] = None  # (..., d, d), d = N + m
    g_inv: Optional[Tensor] = None  # (..., d, d)
    gz: Optional[Tensor] = None  # (..., N, N)
    gz_inv: Optional[Tensor] = None  # (..., N, N)
    mg: Optional[Tensor] = None  # (..., d, N)
    mc: Optional[Tensor] = None  # (..., N, n)


def window_init(window: int, nlift: int, m: int, n: int,
                dtype: torch.dtype = torch.float32, device=None,
                carry: bool = False, ridge: float = 1e-4,
                store_dtype: Optional[torch.dtype] = None) -> WindowState:
    """Zero rings for one scenario, stored in ``store_dtype`` (default:
    the run's ``dtype``); with ``carry`` the Woodbury lane's statistics of
    an empty window (ridge I, its inverse, zero cross-Grams) in ``dtype``."""
    sd = dtype if store_dtype is None else store_dtype
    kw = dict(dtype=sd, device=device)
    st = WindowState(
        zx=torch.zeros((window, nlift), **kw),
        u=torch.zeros((window, m), **kw),
        zy=torch.zeros((window, nlift), **kw),
        x=torch.zeros((window, n), **kw),
        idx=torch.zeros((), dtype=torch.int32, device=device),
    )
    if carry:
        d = nlift + m
        eye = lambda k: torch.eye(k, dtype=dtype, device=device)
        st = st._replace(
            g=ridge * eye(d), g_inv=(1.0 / ridge) * eye(d),
            gz=ridge * eye(nlift), gz_inv=(1.0 / ridge) * eye(nlift),
            mg=torch.zeros((d, nlift), dtype=dtype, device=device),
            mc=torch.zeros((nlift, n), dtype=dtype, device=device),
        )
    return st


def _gram(v: Tensor) -> Tensor:
    return v.transpose(-1, -2) @ v


def window_prefill(state: WindowState, zx: Tensor, u: Tensor, zy: Tensor,
                   x: Tensor) -> WindowState:
    """Fill one scenario's rings with the last (up to W) training
    snapshots, so that the first refit is well posed; the cursor points
    past them. In the Woodbury lane the carried statistics are then built
    exactly from the filled rings (``spd_inverse`` for the inverses: a
    one-time setup cost)."""
    w = state.zx.shape[0]
    take = min(w, zx.shape[0])

    def fill(ring: Tensor, rows: Tensor) -> Tensor:
        out = ring.clone()
        out[:take] = rows[rows.shape[0] - take:].to(ring.dtype)
        return out

    new = state._replace(
        zx=fill(state.zx, zx), u=fill(state.u, u), zy=fill(state.zy, zy),
        x=fill(state.x, x),
        idx=torch.full_like(state.idx, take % w),
    )
    if state.g is None:
        return new
    cd = state.g.dtype
    # ridge I, as the initial statistics hold it (the rings were zeros)
    ridge_eye_d = state.g - _gram(torch.cat([state.zx, state.u], -1).to(cd))
    ridge_eye_n = state.gz - _gram(state.zx.to(cd))
    v = torch.cat([new.zx, new.u], -1).to(cd)
    zxc = new.zx.to(cd)
    g = _gram(v) + ridge_eye_d
    gz = _gram(zxc) + ridge_eye_n
    return new._replace(
        g=g, g_inv=spd_inverse(g), gz=gz, gz_inv=spd_inverse(gz),
        mg=v.transpose(-1, -2) @ new.zy.to(cd),
        mc=zxc.transpose(-1, -2) @ new.x.to(cd),
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

    return state._replace(
        zx=write(state.zx, z), u=write(state.u, u),
        zy=write(state.zy, z_next), x=write(state.x, x_target),
        idx=(state.idx + 1) % w,
    )


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return a[..., :, None] * b[..., None, :]


def _sm_step(x: Tensor, c: Tensor, sign: float) -> Tensor:
    """Sherman-Morrison, per scenario: (G + sign c c')^-1 from X = G^-1.
    The removal's denominator 1 - c'Xc is clamped at 1e-6 (the ridge keeps
    it positive for a row that is in the window; the clamp guards a row
    that drifted out of step, whose error the polish then contracts)."""
    xc = (x @ c[..., :, None])[..., 0]
    denom = 1.0 + sign * (c * xc).sum(-1)
    if sign < 0:
        denom = torch.clamp(denom, min=1e-6)
    return x - (sign / denom)[..., None, None] * _outer(xc, xc)


def _polished(mat: Tensor, inv: Tensor, polish: int) -> Tensor:
    """``polish`` Newton-Schulz steps of ``inv`` against the exact carried
    Gram ``mat``, with the divergence safeguard: from the last step's
    h = mat inv (taken before that step's update), r^2 = ||h - I||_F^2; a
    scenario whose r^2 is non-finite or above 4d (a healthy iterate is at
    most d) restarts from the globally convergent seed
    mat' / (||mat||_1 ||mat||_inf), not polished on this step. The
    result is symmetrized."""
    d = mat.shape[-1]
    eye = torch.eye(d, dtype=mat.dtype, device=mat.device)
    eye2 = 2.0 * eye
    h = None
    for _ in range(polish):
        h = mat @ inv
        inv = inv @ (eye2 - h)
    if h is not None:
        r2 = ((h - eye) ** 2).sum((-2, -1))
        bad = ~torch.isfinite(r2) | (r2 > 4.0 * d)
        absm = mat.abs()
        norm1 = absm.sum(-2).amax(-1)
        norminf = absm.sum(-1).amax(-1)
        seed = mat.transpose(-1, -2) / torch.clamp(
            norm1 * norminf, min=1e-30)[..., None, None]
        inv = torch.where(bad[..., None, None], seed, inv)
    return 0.5 * (inv + inv.transpose(-1, -2))


def window_update_carry(state: WindowState, z: Tensor, u: Tensor,
                        z_next: Tensor, x_target: Tensor, polish: int = 1
                        ) -> WindowState:
    """The Woodbury lane's update, per scenario (state (B, ...), rows
    (B, .)): the ring replaces one row, so each Gram moves by rank 2 (add
    the new row, remove the evicted one) and each cross-Gram by rank 1
    each way; the inverses follow by add-then-remove Sherman-Morrison and
    ``polish`` Newton-Schulz steps against the exact carried Grams
    (:func:`_polished`, with the divergence safeguard; it needs
    ``polish`` >= 1). The carried inverse tracks the exact ridge inverse:
    the truncated chain's spectral filter is not reproduced."""
    rows = torch.arange(state.idx.shape[0], device=state.idx.device)
    i = state.idx.long()
    sd, cd = state.zx.dtype, state.g.dtype
    # quantize to the storage dtype first, and use the quantized rows for
    # both the ring write and the statistics
    z_q, u_q, zn_q, xt_q = (t.to(sd) for t in (z, u, z_next, x_target))
    z, u, z_next, x_target = (t.to(cd) for t in (z_q, u_q, zn_q, xt_q))
    # the rows being evicted, read before the write
    z_old, u_old, zy_old, x_old = (ring[rows, i].to(cd) for ring in
                                   (state.zx, state.u, state.zy, state.x))
    v_new = torch.cat([z, u], -1)
    v_old = torch.cat([z_old, u_old], -1)

    g = state.g + _outer(v_new, v_new) - _outer(v_old, v_old)
    gz = state.gz + _outer(z, z) - _outer(z_old, z_old)
    mg = state.mg + _outer(v_new, z_next) - _outer(v_old, zy_old)
    mc = state.mc + _outer(z, x_target) - _outer(z_old, x_old)

    g_inv = _sm_step(_sm_step(state.g_inv, v_new, 1.0), v_old, -1.0)
    gz_inv = _sm_step(_sm_step(state.gz_inv, z, 1.0), z_old, -1.0)
    g_inv = _polished(g, g_inv, polish)
    gz_inv = _polished(gz, gz_inv, polish)

    return window_update(state, z_q, u_q, zn_q, xt_q)._replace(
        g=g, g_inv=g_inv, gz=gz, gz_inv=gz_inv, mg=mg, mc=mc)


def window_model_carry(state: WindowState, nlift: int) -> LinearModel:
    """The model from the carried statistics: ``[A B] = (g^-1 mg)'``,
    ``C = (gz^-1 mc)'``."""
    k_ext = (state.g_inv @ state.mg).transpose(-1, -2)
    c = (state.gz_inv @ state.mc).transpose(-1, -2)
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:], C=c)


def window_reanchor(state: WindowState, ridge: float) -> WindowState:
    """Rebuild the carried statistics exactly from the rings, in the
    carried dtype (the Woodbury lane's periodic drift reset)."""
    cd = state.g.dtype
    zx = state.zx.to(cd)
    v = torch.cat([zx, state.u.to(cd)], -1)
    eye = lambda k: torch.eye(k, dtype=cd, device=zx.device)
    g = _gram(v) + ridge * eye(v.shape[-1])
    gz = _gram(zx) + ridge * eye(zx.shape[-1])
    return state._replace(
        g=g, g_inv=spd_inverse(g), gz=gz, gz_inv=spd_inverse(gz),
        mg=v.transpose(-1, -2) @ state.zy.to(cd),
        mc=zx.transpose(-1, -2) @ state.x.to(cd),
    )


def window_model(state: WindowState, nlift: int, ridge: float = 1e-4,
                 schulz_iters: int = 24) -> LinearModel:
    """Refit (A, B, C) from the window's ridge normal equations:
    ``[A B] = Zy' V (V'V + ridge I)^-1``, ``C = X' Zx (Zx'Zx + ridge I)^-1``,
    the inverses by ``schulz_iters`` Newton-Schulz steps, or exact
    (``spd_inverse``) with ``schulz_iters=0``. Computes in float64 for a
    float64 ring and in float32 for any other (a compressed ring's
    quantization perturbs the data, not the arithmetic)."""
    cd = torch.float64 if state.zx.dtype == torch.float64 else torch.float32
    zx, zy, x = (t.to(cd) for t in (state.zx, state.zy, state.x))
    v = torch.cat([zx, state.u.to(cd)], dim=-1)  # (..., W, N+m)
    vt, zxt = v.transpose(-1, -2), zx.transpose(-1, -2)
    eye = lambda k: torch.eye(k, dtype=cd, device=v.device)
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
