"""Batch EDMD regression through Gram statistics (counterpart of
``koopmanx/edmd/batch.py:46-121``), and the direct pseudo-inverse fit on
the snapshot matrices."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..lifts.base import Dictionary
from ..systems.data import Snapshots
from ..types import LinearModel


class GramStats(NamedTuple):
    """syv = Zy^T [Zx U], gvv = [Zx U]^T [Zx U], sxz = X^T Zx,
    gzz = Zx^T Zx, count = snapshot count."""

    syv: Tensor
    gvv: Tensor
    sxz: Tensor
    gzz: Tensor
    count: Tensor


def lift_snapshots(dictionary: Dictionary, data: Snapshots
                   ) -> Tuple[Tensor, Tensor]:
    """Every snapshot pair lifted in one batched call: (psi(X), psi(Y))."""
    return dictionary(data.x), dictionary(data.y)


def gram_stats(zx: Tensor, zy: Tensor, u: Tensor, x: Tensor) -> GramStats:
    v = torch.cat([zx, u], dim=-1)  # (S, N+m)
    return GramStats(
        syv=zy.T @ v,
        gvv=v.T @ v,
        sxz=x.T @ zx,
        gzz=zx.T @ zx,
        count=torch.tensor(zx.shape[0], dtype=zx.dtype, device=zx.device),
    )


def combine_gram_stats(a: GramStats, b: GramStats) -> GramStats:
    """The statistics of two snapshot sets together (their sums)."""
    return GramStats(*(p + q for p, q in zip(a, b)))


def pinv(a: Tensor, rcond: Optional[float] = None) -> Tensor:
    """Pseudo-inverse with ``jnp.linalg.pinv``'s cutoff: singular values at
    most ``rcond`` times the largest are dropped, ``rcond`` by default
    ``10 * max(M, N) * eps``. ``torch.linalg.pinv``'s own default is
    ``max(M, N) * eps``, ten times smaller, so the cutoff is passed
    explicitly.

    A matrix with a non-finite entry gives an all-NaN pseudo-inverse, as
    JAX's does (torch's SVD raises on one instead), so that the engine's
    guard holds that scenario alone."""
    rtol = (10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
            if rcond is None else rcond)
    finite = torch.isfinite(a).all(-1).all(-1)[..., None, None]
    out = torch.linalg.pinv(torch.where(finite, a, 0.0), rtol=rtol)
    return torch.where(finite, out, float("nan"))


def fit_from_grams(stats: GramStats, nlift: int, method: str = "pinv",
                   rcond: Optional[float] = None) -> LinearModel:
    """The two normal-equation systems from Gram statistics:
    ``K = syv gvv^-1`` -> [A B], ``C = sxz gzz^-1``. ``method='pinv'``
    (the reference's pseudo-inverse, cutoff ``rcond``) or ``'solve'`` (a
    linear solve on the transposed Grams, as ``jnp.linalg.solve``;
    ``rcond`` is unused)."""
    if method == "pinv":
        k_ext = stats.syv @ pinv(stats.gvv, rcond)
        c = stats.sxz @ pinv(stats.gzz, rcond)
    elif method == "solve":
        k_ext = torch.linalg.solve(stats.gvv.mT, stats.syv.mT).mT
        c = torch.linalg.solve(stats.gzz.mT, stats.sxz.mT).mT
    else:
        raise ValueError(f"unknown method {method!r}")
    return LinearModel(A=k_ext[..., :, :nlift], B=k_ext[..., :, nlift:], C=c)


def edmd_fit(dictionary: Dictionary, data: Snapshots, method: str = "pinv",
             rcond: Optional[float] = None) -> LinearModel:
    """Batch EDMD: (A, B) from lifted one-step pairs, C from the output
    regression (``duffing.py:167-177``), by :func:`fit_from_grams`."""
    zx, zy = lift_snapshots(dictionary, data)
    stats = gram_stats(zx, zy, data.u, data.x)
    return fit_from_grams(stats, dictionary.nlift, method, rcond)


def edmd_fit_pinv_direct(dictionary: Dictionary, data: Snapshots
                         ) -> LinearModel:
    """The pseudo-inverse fit on the snapshot matrices themselves, the
    closest to the reference's ``Phi_Y @ pinv([Phi_X; U])``
    (``duffing.py:167``): [A B] = (pinv([Zx U]) Zy)', C = (pinv(Zx) X)'.
    For parity checks; the Gram path is the engine's."""
    zx, zy = lift_snapshots(dictionary, data)
    k_ext = (pinv(torch.cat([zx, data.u], dim=-1)) @ zy).T
    c = (pinv(zx) @ data.x).T
    nlift = dictionary.nlift
    return LinearModel(A=k_ext[:, :nlift], B=k_ext[:, nlift:], C=c)
