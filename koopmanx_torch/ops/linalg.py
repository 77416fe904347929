"""Batched small-matrix linear algebra (counterpart of
``koopmanx/ops/linalg.py:26-97``).

``spd_inverse`` is the pivot-free Gauss-Jordan inverse of a symmetric
positive-definite matrix that the engine applies to the ADMM KKT matrix
every step. It runs as plain batched PyTorch ops on (B, n, n) tensors.
"""
from __future__ import annotations

import torch
from torch import Tensor


def spd_inverse(k: Tensor, block: int = 1, eps: float = 0.0) -> Tensor:
    """Inverse of a batch of SPD matrices, (..., n, n) -> (..., n, n);
    ``eps`` > 0 adds a diagonal ridge first (0 leaves ``k`` untouched).

    Pivot-free Gauss-Jordan on the augmented ``[K | I]``. ``block`` > 1
    eliminates ``block`` columns per pass: the pivot rows are first
    normalized by Gauss-Jordan WITHIN the block, with scalar divisions
    (an explicitly inverted pivot block measured 200x worse float32
    residuals in the JAX package), then one rank-``block`` update
    eliminates those columns from every row. The result is symmetrized,
    as the ADMM relies on a symmetric inverse. A singular or indefinite
    input yields inf/NaN, which the engine's guards sanitize.
    """
    n = k.shape[-1]
    if eps:
        k = k + eps * torch.eye(n, dtype=k.dtype, device=k.device)
    eye = torch.eye(n, dtype=k.dtype, device=k.device).expand(k.shape)
    aug = torch.cat([k, eye], dim=-1)  # (..., n, 2n)
    if block <= 1:
        for j in range(n):
            d = aug[..., j, j : j + 1]  # (..., 1)
            piv = aug[..., j, :] / d  # (..., 2n)
            # factor_j = d - 1 (not 0) makes the same rank-1 update
            # normalize the pivot row: d*piv - (d-1)*piv = piv
            factor = aug[..., :, j].clone()
            factor[..., j] = d[..., 0] - 1.0
            aug = aug - factor[..., :, None] * piv[..., None, :]
    else:
        for j in range(0, n, block):
            r = min(block, n - j)
            piv = aug[..., j : j + r, :]  # (..., r, 2n)
            for t in range(r):
                row_t = piv[..., t, :] / piv[..., t, j + t : j + t + 1]
                f = piv[..., :, j + t : j + t + 1]  # (..., r, 1)
                elim = piv - f * row_t[..., None, :]
                keep = torch.arange(r, device=k.device) == t
                piv = torch.where(keep[:, None], row_t[..., None, :], elim)
            # one rank-r pass eliminates the r columns from every row; the
            # block rows are then overwritten with their normalized forms
            upd = aug[..., :, j : j + r] @ piv
            aug = aug - upd
            aug[..., j : j + r, :] = piv
    inv = aug[..., :, n:]
    return 0.5 * (inv + inv.transpose(-1, -2))
