"""Batched small-matrix linear algebra (counterpart of
``koopmanx/ops/linalg.py:26-141``).

``spd_inverse`` is the pivot-free Gauss-Jordan inverse of a symmetric
positive-definite matrix that the engine applies to the ADMM KKT matrix
every step; ``ns_tracking_inverse`` (``:144-211``) refines last step's
inverse of that matrix instead, under ``qp_kkt_refine``;
``gj_inverse`` / ``gj_solve`` are Gauss-Jordan with partial pivoting for
the general matrices of the doubling DARE (``control/dare.py``). All run
as plain batched PyTorch ops on (B, n, n) tensors.
"""
from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _gj_tables(n: int, device: torch.device):
    """Data-independent tables of :func:`gj_inverse`, built once per width
    and device (read-only): for each column j the one-hot row mask
    ``rows == j``, and an (n - j, n) table whose row q is the row order
    that swaps rows j and j + q (row 0: no swap). Built as normal tensors
    even under ``torch.inference_mode``: a cached inference tensor would
    refuse a later caller that records a gradient."""
    with torch.inference_mode(False):
        rows = torch.arange(n)
        eq, swaps = [], []
        for j in range(n):
            eq.append((rows == j).to(device))
            perms = rows.repeat(n - j, 1)
            for q in range(1, n - j):
                perms[q, j], perms[q, j + q] = j + q, j
            swaps.append(perms.to(device))
    return eq, swaps


def gj_inverse(a: Tensor) -> Tensor:
    """General-matrix inverse by Gauss-Jordan WITH partial pivoting,
    (..., n, n) -> (..., n, n) (``koopmanx/ops/linalg.py:100-131``).

    Column step j: among rows >= j the largest |entry| of column j is the
    pivot (the first on ties; a NaN counts as the largest, in both
    packages), rows j and p are swapped by one row gather, and one rank-1
    update with ``factor[j] = d - 1`` both eliminates column j and
    normalizes the pivot row. The JAX package's arithmetic, in its order;
    the masks and swap orders come from :func:`_gj_tables`, so a step is
    nine operations.
    """
    n = a.shape[-1]
    eq, swaps = _gj_tables(n, a.device)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    aug = torch.cat([a, eye], dim=-1)  # (..., n, 2n)
    for j in range(n):
        q = aug[..., j:, j].abs().argmax(-1)  # pivot row p = j + q
        order = swaps[j][q]  # (..., n)
        aug = aug.gather(-2, order.unsqueeze(-1).expand(aug.shape))
        d = aug[..., j, j : j + 1]
        piv = aug[..., j, :] / d
        factor = torch.where(eq[j], d - 1.0, aug[..., :, j])
        aug = aug - factor.unsqueeze(-1) * piv.unsqueeze(-2)
    return aug[..., :, n:]


def gj_solve(a: Tensor, b: Tensor) -> Tensor:
    """``a x = b`` as ``gj_inverse(a) @ b`` (``ops/linalg.py:134-141``)."""
    return gj_inverse(a) @ b


def ns_tracking_inverse(k: Tensor, x_prev: Tensor, iters: int,
                        safe_thresh: float = 0.95,
                        cold_iters: int = 12) -> Tensor:
    """Newton-Schulz TRACKING inverse of slowly drifting SPD matrices,
    (..., n, n) -> (..., n, n) (``koopmanx/ops/linalg.py:144-211``):
    ``iters`` steps X <- X (2I - K X) from last step's inverse
    ``x_prev``, then symmetrized.

    Per matrix, branch-free: the carry is kept where its residual
    R = I - K X demonstrably contracts under one step (which squares it
    exactly): ``isfinite(e1) & ((e0 < safe_thresh) | (e1 < 0.7 e0))``
    with e0 = ||R||_F and e1 = ||R^2||_F; elsewhere the cold seed
    I / ||K||_F, polished by ``cold_iters`` steps, replaces it (a stale
    carry with spectral radius past 1, or NaN). The cold chain is computed
    for every matrix on every call, as in the JAX package. It constructs
    an inverse, so it runs in the caller's full precision (the entry
    points pin TF32 off)."""
    n = k.shape[-1]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    fro = lambda m: torch.sqrt((m * m).sum((-2, -1)))
    k_fro = torch.clamp(fro(k), min=1e-30)
    r_prev = eye - k @ x_prev
    e0 = fro(r_prev)
    e1 = fro(r_prev @ r_prev)  # the residual after one step, exactly
    use_prev = torch.isfinite(e1) & ((e0 < safe_thresh) | (e1 < 0.7 * e0))
    x_cold = eye / k_fro[..., None, None]
    for _ in range(cold_iters):
        x_cold = x_cold @ (2.0 * eye - k @ x_cold)
    x = torch.where(use_prev[..., None, None], x_prev, x_cold)
    for _ in range(iters):
        x = x @ (2.0 * eye - k @ x)
    return 0.5 * (x + x.transpose(-1, -2))


def cholesky(a: Tensor) -> Tensor:
    """Lower Cholesky factor of (..., n, n) matrices, as
    ``jnp.linalg.cholesky`` gives it: the input is first symmetrized,
    (a + a') / 2, and a matrix that is not positive definite gets NaN in
    its whole lower triangle and 0 above it, where
    ``torch.linalg.cholesky`` would raise; every other matrix of the batch
    keeps its factor. A matrix with a non-finite entry gets the same
    all-NaN lower triangle: there the LAPACK builds differ (JAX's CPU
    build runs through and leaves NaN where they propagate, torch's stops
    at the first NaN pivot), and NaN wherever either puts one is the
    superset of both."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    finite = torch.isfinite(a).all(-1).all(-1)[..., None, None]
    sym = (a + a.transpose(-1, -2)) / 2
    l, info = torch.linalg.cholesky_ex(torch.where(finite, sym, eye))
    bad = (info != 0)[..., None, None] | ~finite
    lower = torch.ones(n, n, dtype=torch.bool, device=a.device).tril()
    failed = torch.where(lower, float("nan"), 0.0).to(a.dtype)
    return torch.where(bad, failed, l)
