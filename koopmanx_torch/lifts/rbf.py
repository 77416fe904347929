"""RBF dictionaries and k-means centers (counterpart of
``koopmanx/lifts/rbf.py:24-94``).

The kinds of the reference's ``rbf.m:10-45`` (thinplate, gauss, invquad,
invmultquad, polyharmonic) and ``duffing_RBF.py:20-23`` (thinplate_eps)
against K centers held as a buffer. Where ``rbf.m`` patches r = 0's NaN to
0, the guard is a ``where`` on r^2 > 0, as in the JAX package.
:func:`kmeans` places the centers by Lloyd's algorithm over the training
states, on the CPU at setup.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from .base import Dictionary

KINDS = ("thinplate", "thinplate_eps", "gauss", "invquad", "invmultquad",
         "polyharmonic")


class RBF(nn.Module):
    """x (..., n) -> (..., K) radial features against ``centers`` (K, n)."""

    def __init__(self, centers: Tensor, kind: str = "thinplate",
                 eps: float = 1.0, k: int = 1):
        super().__init__()
        kind = kind.lower()
        if kind not in KINDS:
            raise ValueError(f"RBF type not recognized: {kind!r}")
        self.kind, self.eps, self.k = kind, eps, k
        self.register_buffer("centers", centers)

    def forward(self, x: Tensor) -> Tensor:
        diff = x[..., None, :] - self.centers
        r2 = (diff * diff).sum(-1)
        kind, eps2 = self.kind, self.eps ** 2
        if kind in ("thinplate", "polyharmonic"):
            pos = r2 > 0
            safe = torch.where(pos, r2, torch.ones_like(r2))
            if kind == "thinplate":  # rbf.m:27, r^2 log r
                val = 0.5 * safe * torch.log(safe)
            else:  # rbf.m:38, r^k log r
                val = safe ** (self.k / 2.0) * 0.5 * torch.log(safe)
            return torch.where(pos, val, torch.zeros_like(r2))
        if kind == "thinplate_eps":  # duffing_RBF.py:22, d^2 log(d + 1e-4)
            d = torch.sqrt(torch.clamp(r2, min=0.0))
            return r2 * torch.log(d + 1e-4)
        if kind == "gauss":
            return torch.exp(-eps2 * r2)  # rbf.m:31
        if kind == "invquad":
            return 1.0 / (1.0 + eps2 * r2)  # rbf.m:33
        return 1.0 / torch.sqrt(1.0 + eps2 * r2)  # invmultquad, rbf.m:36


def rbf_dictionary(centers: Tensor, kind: str = "thinplate", eps: float = 1.0,
                   k: int = 1) -> Dictionary:
    n_centers, n = centers.shape
    return Dictionary(RBF(centers, kind, eps, k), nlift=n_centers, n=n)


def lloyd(points: Tensor, centers0: Tensor, iters: int = 50
          ) -> Tuple[Tensor, Tensor]:
    """``iters`` Lloyd iterations from ``centers0`` (k, n) over ``points``
    (S, n): assign each point to its nearest center (the first on a tie),
    move each center to its cluster's mean; an empty cluster keeps its
    center. Returns (centers, the final assignments (S,))."""
    k = centers0.shape[0]

    def assign(centers: Tensor) -> Tensor:
        d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        return torch.argmin(d2, dim=-1)

    centers = centers0
    for _ in range(iters):
        one_hot = nn.functional.one_hot(assign(centers), k).to(points.dtype)
        counts = one_hot.sum(0)[:, None]  # (k, 1)
        sums = one_hot.transpose(0, 1) @ points  # (k, n)
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                              centers)
    return centers, assign(centers)


def kmeans(gen: torch.Generator, points: Tensor, k: int, iters: int = 50
           ) -> Tuple[Tensor, Tensor]:
    """k-means centers (k, n) and assignments (S,) of ``points`` (S, n),
    from k distinct points drawn with ``gen`` (the reference's
    ``sklearn.cluster.KMeans``, ``duffing_RBF.py:44-46``)."""
    init = torch.randperm(points.shape[0], generator=gen)[:k]
    return lloyd(points, points[init.to(points.device)], iters)
