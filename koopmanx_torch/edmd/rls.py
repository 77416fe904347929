"""Online least-squares estimators (counterpart of ``koopmanx/edmd/rls.py``):

- the rank-one Sherman-Morrison RLS of the reference (``update='rls'``,
  :60-137): the carry holds the inverse Grams, which the SM step downdates;
- the storage method (``update='storage'``, :140-175): raw Grams grown by
  each observation and pseudo-inverted every step;
- the Gram-carry RLS (``update='rls_chol'``, :329-430): raw Grams, the
  model extracted by an exact SPD inverse with a ridge;
- the square-root (Cholesky-factor) RLS (``update='rls_sqrt'``,
  :189-310): upper-triangular factors of the [z; u] and z Grams, updated
  by Givens rotations, the model extracted with two triangular solves.

Every function takes a leading scenario axis. Each estimator also has
its warm start from the batch Grams of the training snapshots
(``*_init_from_grams``, ``warm_start_from_batch``;
``Revise_2/Koopman_update.m:264-265``).

Precision: this is estimator math and must run in full float32 (the JAX
package pins ``precision='highest'``); the port's entry points turn TF32
off (``device.resolve_device``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..ops.linalg import cholesky, spd_inverse
from ..types import LinearModel, RLSState
from .batch import GramStats, pinv


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return a.unsqueeze(-1) * b.unsqueeze(-2)


def _symmetrized(a: Tensor) -> Tensor:
    return 0.5 * (a + a.transpose(-1, -2))


def rls_init(nlift: int, m: int, n: int, c_ab: float = 1e4, c_c: float = 1e2,
             dtype: torch.dtype = torch.float32, device=None) -> RLSState:
    """``invG = c_ab I``, ``barQ = c_c I`` (duffing.py:929-946; 1e5 in
    vanderpol.py:874,888), one scenario, no batch axis."""
    kw = dict(dtype=dtype, device=device)
    return RLSState(
        K_A=torch.zeros((nlift, nlift + m), **kw),
        invG=c_ab * torch.eye(nlift + m, **kw),
        barX=torch.zeros((n, nlift), **kw),
        barQ=c_c * torch.eye(nlift, **kw),
    )


def rls_init_from_grams(stats: GramStats) -> RLSState:
    """Warm start from the batch statistics (``rls.py:79-88``):
    ``K_A = Zy' V``, ``invG = pinv(V' V)``, ``barX = X' Zx``,
    ``barQ = pinv(Zx' Zx)``, with the JAX package's pinv cutoff."""
    return RLSState(K_A=stats.syv, invG=pinv(stats.gvv), barX=stats.sxz,
                    barQ=pinv(stats.gzz))


def _sm_downdate(inv_g: Tensor, v: Tensor, lam: float) -> Tensor:
    """One Sherman-Morrison step on an inverse Gram,
    ``(invG - (invG v)(invG v)' / (lam + v' invG v)) / lam``."""
    gv = (inv_g @ v.unsqueeze(-1)).squeeze(-1)
    denom = lam + (v * gv).sum(-1)
    return (inv_g - _outer(gv, gv) / denom[..., None, None]) / lam


def rls_update_ab(state: RLSState, z: Tensor, u: Tensor, z_next: Tensor,
                  lam: float = 1.0, symmetrize: bool = False) -> RLSState:
    """Rank-one update of the [A B] regression with the observation
    (v = [z; u], z+) (duffing.py:932-937)."""
    v = torch.cat([z, u], dim=-1)
    inv_g = _sm_downdate(state.invG, v, lam)
    if symmetrize:
        inv_g = _symmetrized(inv_g)
    return state._replace(K_A=state.K_A + _outer(z_next, v), invG=inv_g)


def rls_update_c(state: RLSState, z: Tensor, x_target: Tensor,
                 lam: float = 1.0, symmetrize: bool = False) -> RLSState:
    """Rank-one update of the output regression C z ~ x with the pair
    (z, x_target) (duffing.py:942-953)."""
    bar_q = _sm_downdate(state.barQ, z, lam)
    if symmetrize:
        bar_q = _symmetrized(bar_q)
    return state._replace(barX=state.barX + _outer(x_target, z), barQ=bar_q)


class StorageState(NamedTuple):
    """Carry of the storage method (duffing_RBF.py:404-438): the raw Grams
    of every observation so far, training snapshots included, the
    sufficient statistics of the growing snapshot buffers."""

    syv: Tensor  # (..., N, N+m)
    gvv: Tensor  # (..., N+m, N+m)
    sxz: Tensor  # (..., n, N)
    gzz: Tensor  # (..., N, N)


def storage_init(stats: GramStats) -> StorageState:
    return StorageState(stats.syv, stats.gvv, stats.sxz, stats.gzz)


def storage_update(state: StorageState, z: Tensor, u: Tensor, z_next: Tensor,
                   x_target: Tensor) -> StorageState:
    v = torch.cat([z, u], dim=-1)
    return StorageState(
        syv=state.syv + _outer(z_next, v),
        gvv=state.gvv + _outer(v, v),
        sxz=state.sxz + _outer(x_target, z),
        gzz=state.gzz + _outer(z, z),
    )


def storage_model(state: StorageState, nlift: int) -> LinearModel:
    """The batch fit on the grown Grams: two pseudo-inverses a step, with
    the JAX package's cutoff (``batch.pinv``)."""
    k_ext = state.syv @ pinv(state.gvv)
    c = state.sxz @ pinv(state.gzz)
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:], C=c)


class GramRLSState(NamedTuple):
    """Carry of the Gram-carry RLS (``update='rls_chol'``): K_A / barX
    accumulate as in the reference (duffing.py:937, 943); g / q are the raw
    Grams of [z; u] and z."""

    K_A: Tensor  # (..., N, N+m)
    g: Tensor  # (..., N+m, N+m)
    barX: Tensor  # (..., p, N)
    q: Tensor  # (..., N, N)


def gram_rls_init(nlift: int, m: int, n: int, c_ab: float = 1e4,
                  c_c: float = 1e2, dtype: torch.dtype = torch.float32,
                  device=None) -> GramRLSState:
    """The prior of :func:`rls_init`: inv(G0) = c I, so G0 = I / c."""
    kw = dict(dtype=dtype, device=device)
    return GramRLSState(
        K_A=torch.zeros((nlift, nlift + m), **kw),
        g=torch.eye(nlift + m, **kw) / c_ab,
        barX=torch.zeros((n, nlift), **kw),
        q=torch.eye(nlift, **kw) / c_c,
    )


def gram_rls_init_from_grams(stats: GramStats) -> GramRLSState:
    """Warm start from the batch Grams themselves (``rls.py:351-352``)."""
    return GramRLSState(K_A=stats.syv, g=stats.gvv, barX=stats.sxz,
                        q=stats.gzz)


def gram_rls_update(state: GramRLSState, z: Tensor, u: Tensor,
                    z_next: Tensor, x_target: Tensor, lam: float = 1.0
                    ) -> GramRLSState:
    """Both rank-one updates, the Grams first scaled by ``lam`` < 1."""
    v = torch.cat([z, u], dim=-1)
    g = state.g if lam == 1.0 else lam * state.g
    q = state.q if lam == 1.0 else lam * state.q
    return GramRLSState(
        K_A=state.K_A + _outer(z_next, v),
        g=g + _outer(v, v),
        barX=state.barX + _outer(x_target, z),
        q=q + _outer(z, z),
    )


def gram_rls_model(state: GramRLSState, nlift: int, ridge: float = 1e-6,
                   schulz_iters: int = 0) -> LinearModel:
    """K_ext = K_A (G + ridge I)^-1 and C = barX (Q + ridge I)^-1 through
    the exact pivot-free ``spd_inverse``; ``schulz_iters`` > 0 selects the
    JAX package's legacy Newton-Schulz extraction instead."""
    if schulz_iters:
        eye = lambda a: torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        g_inv = schulz_inverse(state.g + ridge * eye(state.g), schulz_iters)
        q_inv = schulz_inverse(state.q + ridge * eye(state.q), schulz_iters)
    else:
        g_inv = spd_inverse(state.g, eps=ridge)
        q_inv = spd_inverse(state.q, eps=ridge)
    k_ext = state.K_A @ g_inv
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:],
                       C=state.barX @ q_inv)


class SqrtRLSState(NamedTuple):
    """K_A / barX accumulate ``z+ [z;u]'`` and ``x z'``; r_g / r_q are the
    Cholesky factors of the [z;u] and z Grams (G = r_g' r_g); ``count``
    cycles the ridge trickle and is per scenario, because the guard can
    hold one scenario's carry back."""

    K_A: Tensor  # (..., N, N+m)
    r_g: Tensor  # (..., N+m, N+m) upper triangular
    barX: Tensor  # (..., p, N)
    r_q: Tensor  # (..., N, N) upper triangular
    count: Tensor  # (...,) int32 step counter


def chol_rank1_update(r: Tensor, v: Tensor) -> Tensor:
    """Cholesky factor of ``R'R + v v'`` by d Givens rotations, batched:
    r (B, d, d), v (B, d). The zero column (rho = 0) keeps its row. The
    rotated rows are stacked at the end, out of place, so autograd can
    differentiate through the update."""
    d = r.shape[-1]
    rows = list(r.unbind(-2))
    for k in range(d):
        row = rows[k]
        rkk = row[..., k]
        vk = v[..., k]
        rho = torch.sqrt(rkk * rkk + vk * vk)
        safe = rho > 0
        den = torch.where(safe, rho, torch.ones_like(rho))
        c = torch.where(safe, rkk / den, torch.ones_like(rho))
        s = torch.where(safe, vk / den, torch.zeros_like(rho))
        rows[k] = c[..., None] * row + s[..., None] * v
        v = c[..., None] * v - s[..., None] * row
    return torch.stack(rows, dim=-2)


def sqrt_rls_init(nlift: int, m: int, n: int, c_ab: float = 1e4,
                  c_c: float = 1e2, dtype: torch.dtype = torch.float32,
                  device=None) -> SqrtRLSState:
    """inv(G) = c I  <=>  R = sqrt(1/c) I (one scenario, no batch axis)."""
    kw = dict(dtype=dtype, device=device)
    return SqrtRLSState(
        K_A=torch.zeros((nlift, nlift + m), **kw),
        r_g=(1.0 / c_ab) ** 0.5 * torch.eye(nlift + m, **kw),
        barX=torch.zeros((n, nlift), **kw),
        r_q=(1.0 / c_c) ** 0.5 * torch.eye(nlift, **kw),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def sqrt_rls_init_from_grams(stats: GramStats) -> SqrtRLSState:
    """Warm start from the batch Grams' upper Cholesky factors
    (``rls.py:240-248``); a Gram that is not positive definite gives NaN
    factors, as in the JAX package (``ops/linalg.cholesky``)."""
    count = torch.zeros(stats.syv.shape[:-2], dtype=torch.int32,
                        device=stats.syv.device)
    return SqrtRLSState(K_A=stats.syv,
                        r_g=cholesky(stats.gvv).transpose(-1, -2),
                        barX=stats.sxz,
                        r_q=cholesky(stats.gzz).transpose(-1, -2),
                        count=count)


def _ridge_vector(count: Tensor, d: int, ridge: float, like: Tensor) -> Tensor:
    """``ridge`` at index ``count % d`` of each scenario, zero elsewhere."""
    e = torch.zeros(like.shape[:-2] + (d,), dtype=like.dtype, device=like.device)
    idx = (count % d).long().unsqueeze(-1)
    return e.scatter(-1, idx, ridge)


def sqrt_rls_update_ab(state: SqrtRLSState, z: Tensor, u: Tensor,
                       z_next: Tensor, lam: float = 1.0, ridge: float = 0.0
                       ) -> SqrtRLSState:
    """Rank-one update of the [A B] Gram; with ``ridge`` > 0 a second
    rank-one update puts ``ridge^2`` on one cycling diagonal entry. Then
    ``count`` is incremented, so the C-side update reads the new count."""
    v = torch.cat([z, u], dim=-1)
    d = v.shape[-1]
    r_g = state.r_g if lam == 1.0 else lam ** 0.5 * state.r_g
    r_g = chol_rank1_update(r_g, v)
    if ridge > 0.0:
        r_g = chol_rank1_update(r_g, _ridge_vector(state.count, d, ridge, r_g))
    return state._replace(
        K_A=state.K_A + z_next.unsqueeze(-1) * v.unsqueeze(-2),
        r_g=r_g,
        count=state.count + 1,
    )


def sqrt_rls_update_c(state: SqrtRLSState, z: Tensor, x_target: Tensor,
                      lam: float = 1.0, ridge: float = 0.0) -> SqrtRLSState:
    """Rank-one update of the output regression; the ridge index is the
    count as left by :func:`sqrt_rls_update_ab` (post-increment)."""
    d = z.shape[-1]
    r_q = state.r_q if lam == 1.0 else lam ** 0.5 * state.r_q
    r_q = chol_rank1_update(r_q, z)
    if ridge > 0.0:
        r_q = chol_rank1_update(r_q, _ridge_vector(state.count, d, ridge, r_q))
    return state._replace(
        barX=state.barX + x_target.unsqueeze(-1) * z.unsqueeze(-2), r_q=r_q
    )


def _solve_gram(r: Tensor, rhs: Tensor) -> Tensor:
    """Solve (R'R) X = rhs with two triangular solves."""
    y = torch.linalg.solve_triangular(r.transpose(-1, -2), rhs, upper=False)
    return torch.linalg.solve_triangular(r, y, upper=True)


def sqrt_rls_model(state: SqrtRLSState, nlift: int) -> LinearModel:
    """K_ext = K_A G^{-1} and C = barX Q^{-1} from the factors."""
    k_ext = _solve_gram(state.r_g, state.K_A.transpose(-1, -2)).transpose(-1, -2)
    c = _solve_gram(state.r_q, state.barX.transpose(-1, -2)).transpose(-1, -2)
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:], C=c)


def schulz_inverse(a: Tensor, iters: int = 24) -> Tensor:
    """Newton-Schulz iterative inverse of (..., d, d) matrices
    (``koopmanx/edmd/rls.py:376-406``): ``X <- X (2I - A X)`` for ``iters``
    steps from the globally convergent seed ``A' / (||A||_1 ||A||_inf)``.
    Truncated on purpose where the windowed estimator calls it: the
    unconverged weakest directions are its spectral filter."""
    d = a.shape[-1]
    absa = a.abs()
    norm1 = absa.sum(-2).amax(-1)
    norminf = absa.sum(-1).amax(-1)
    x = a.transpose(-1, -2) / (norm1 * norminf)[..., None, None]
    eye2 = 2.0 * torch.eye(d, dtype=a.dtype, device=a.device)
    for _ in range(iters):
        x = x @ (eye2 - a @ x)
    return x
