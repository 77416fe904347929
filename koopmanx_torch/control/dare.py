"""DARE / LQR utilities (counterpart of ``koopmanx/control/dare.py``).

Every function takes a leading scenario axis where the JAX package was
``vmap``-ed: a (B, n, n), b (B, n, m), q (B, n, n), r (B, m, m); the
fixed-length ``lax.scan`` loops are Python loops.

- :func:`solve_dare_iter`: the reference's fixed-point recursion
  (``duffing.py:583-599``), 500 iterations, its gain through ``pinv``;
- :func:`solve_dare_doubling`: the structure-preserving doubling
  algorithm, 30 iterations of small products and two pivoted
  Gauss-Jordan solves each, the per-step terminal synthesis's solver;
- :func:`dlqr_gain`, :func:`dlqr`, :func:`controllability_rank` and
  :func:`solve_dlyap_doubling`.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..edmd.batch import pinv
from ..ops.linalg import gj_solve, spd_inverse


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def solve_dare_iter(a: Tensor, b: Tensor, q: Tensor, r: Tensor,
                    iters: int = 500) -> Tensor:
    """Fixed-point DARE iteration (``dare.py:25-38``):
    X <- A'XA - (A'XB) pinv(R + B'XB) (B'XA) + Q from X = Q."""
    x = q
    for _ in range(iters):
        btx = _t(b) @ x
        gain = pinv(r + btx @ b) @ (btx @ a)
        x = _t(a) @ x @ a - (_t(a) @ x @ b) @ gain + q
    return x


def solve_dare_doubling(a: Tensor, b: Tensor, q: Tensor, r: Tensor,
                        iters: int = 30) -> Tensor:
    """Structure-preserving doubling for the DARE (``dare.py:41-63``):
    from (A, G, H) = (A, B R^-1 B', Q),
      W = (I + G H)^-1 A,  A <- A W,
      G <- G + A G (I + H G)^-1 A',  H <- H + W' H A,
    the two solves by :func:`gj_solve` in the JAX package's order; H
    converges to P."""
    g = b @ (spd_inverse(r) @ _t(b))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    ak, gk, hk = a, g, q
    for _ in range(iters):
        w = gj_solve(eye + gk @ hk, ak)  # (I + G H)^-1 A
        a_next = ak @ w
        g_next = gk + ak @ gk @ gj_solve(eye + hk @ gk, _t(ak))
        h_next = hk + _t(w) @ hk @ ak
        ak, gk, hk = a_next, g_next, h_next
    return hk


def dlqr_gain(a: Tensor, b: Tensor, q: Tensor, r: Tensor, p: Tensor
              ) -> Tensor:
    """K = (R + B'PB)^-1 (B'PA) (``dare.py:66-73``), the control law
    u = -K x; R + B'PB is SPD, so ``spd_inverse`` stands for the pinv of
    ``duffing.py:601-613``."""
    btp = _t(b) @ p
    return spd_inverse(r + btp @ b) @ (btp @ a)


def dlqr(a: Tensor, b: Tensor, q: Tensor, r: Tensor,
         method: str = "doubling"):
    """(K, P); ``method='iter'`` is the reference's fixed point."""
    if method == "iter":
        p = solve_dare_iter(a, b, q, r)
    else:
        p = solve_dare_doubling(a, b, q, r)
    return dlqr_gain(a, b, q, r, p), p


def controllability_rank(a: Tensor, b: Tensor) -> Tensor:
    """rank([B AB ... A^{n-1}B]) per scenario (``dare.py:86-95``), with
    ``jnp.linalg.matrix_rank``'s cutoff: singular values above
    max(M, N) eps times the largest."""
    blocks, pb = [], b
    for _ in range(a.shape[-1]):
        blocks.append(pb)
        pb = a @ pb
    return torch.linalg.matrix_rank(torch.cat(blocks, dim=-1))


def solve_dlyap_doubling(a: Tensor, q: Tensor, iters: int = 30) -> Tensor:
    """P = A'PA + Q by doubling (``dare.py:98-108``):
    P <- P + M'PM, M <- M^2 from (Q, A)."""
    p, m = q, a
    for _ in range(iters):
        p, m = p + _t(m) @ p @ m, m @ m
    return p
