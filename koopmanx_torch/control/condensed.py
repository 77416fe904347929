"""Condensed (dense) MPC QP construction (counterpart of
``koopmanx/control/condensed.py``: ``prediction_matrices`` :53-93 with the
'dag' :223-246, 'doubling' :173-192, 'assoc' :208-220 and 'scan' :37-50
builds, ``augment_delta_u`` :96-112, ``weight_bar`` :115-123 with its
terminal-block override and ``condensed_qp`` :126-170, box and general).

All functions take a leading scenario axis (models (B, N, N) etc.).

  F1 = [C A; C A^2; ...; C A^N]                          (N*py, nz)
  F2 = block-lower-triangular Toeplitz of C A^{j-1} B    (N*py, N*m)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from ..types import LinearModel, QPData


class PredictionMatrices(NamedTuple):
    f1: Tensor  # (..., N*py, nz)
    f2: Tensor  # (..., N*py, N*m)


class BoxQP(NamedTuple):
    """``min 1/2 x'Px + q'x  s.t.  l <= x <= u`` (OSQP form with A = I)."""

    P: Tensor
    q: Tensor
    l: Tensor
    u: Tensor


def markov_scan(a: Tensor, b: Tensor, cy_c: Tensor, horizon: int):
    """Linear-depth recursion: rows_j = CyC A^{j+1}, markov_j = CyC A^j B."""
    rows, markov = [], []
    g = cy_c
    for _ in range(horizon):
        g_next = g @ a
        rows.append(g_next)
        markov.append(g @ b)
        g = g_next
    return torch.stack(rows, dim=-3), torch.stack(markov, dim=-3)


def markov_dag(a: Tensor, b: Tensor, cy_c: Tensor, horizon: int):
    """Per-row binary-composition DAG: the ladder A^(2^r), then each row
    g_j = g_{j - 2^r} A^(2^r) with 2^r the largest power <= j."""
    ladder = [a]
    while len(ladder) < horizon.bit_length():
        ladder.append(ladder[-1] @ ladder[-1])
    g = [cy_c]
    for j in range(1, horizon + 1):
        r = j.bit_length() - 1
        g.append(g[j - (1 << r)] @ ladder[r])
    rows = torch.stack(g[1:], dim=-3)  # (..., N, py, nz)
    markov = torch.stack(g[:horizon], dim=-3) @ b.unsqueeze(-3)  # (..., N, py, m)
    return rows, markov


def _rows_markov_from_powers(powers: Tensor, b: Tensor, cy_c: Tensor):
    """(rows, markov) from the stack [A^1..A^N] (..., N, nz, nz):
    rows_j = CyC A^{j+1}, markov_j = (CyC A^j) B."""
    nz = powers.shape[-1]
    eye = torch.eye(nz, dtype=powers.dtype, device=powers.device)
    pow0 = torch.cat([eye.expand(powers.shape[:-3] + (1, nz, nz)),
                      powers[..., :-1, :, :]], dim=-3)  # A^0..A^(N-1)
    cy = cy_c.unsqueeze(-3)
    markov = (cy @ pow0) @ b.unsqueeze(-3)  # (..., N, py, m)
    rows = cy @ powers  # (..., N, py, nz)
    return rows, markov


def markov_doubling(a: Tensor, b: Tensor, cy_c: Tensor, horizon: int):
    """The power stack [A^1..A^N] by doubling: [A^1] -> [A^1..A^2] -> ...,
    each round the stack times its top power, concatenated, in
    ceil(log2 N) rounds; then the rows and Markov parameters from it."""
    powers = a.unsqueeze(-3)  # (..., 1, nz, nz)
    while powers.shape[-3] < horizon:
        top = powers[..., -1:, :, :]  # A^(len)
        powers = torch.cat([powers, powers @ top], dim=-3)
    return _rows_markov_from_powers(powers[..., :horizon, :, :], b, cy_c)


def markov_assoc(a: Tensor, b: Tensor, cy_c: Tensor, horizon: int):
    """The power stack [A^1..A^N] as an inclusive matmul scan of N copies
    of A on one fixed (..., N, nz, nz) buffer, in log depth: an up-sweep
    leaves at index i the product of the 2^t entries that end there (2^t
    the largest power of two dividing i + 1), then a down-sweep completes
    the other prefixes, each level one batched matmul over the indices it
    writes (disjoint from those it reads). ``lax.associative_scan``'s
    shape without the concatenations of :func:`markov_doubling`."""
    buf = a.unsqueeze(-3).expand(
        a.shape[:-2] + (horizon,) + a.shape[-2:]).clone()
    top = 1 << (horizon - 1).bit_length()  # the power of two >= horizon
    at = lambda start, step: torch.arange(start, max(start, horizon), step,
                                          device=a.device)
    d = 1
    while d < horizon:  # up-sweep
        idx = at(2 * d - 1, 2 * d)
        buf[..., idx, :, :] = buf[..., idx - d, :, :] @ buf[..., idx, :, :]
        d *= 2
    d = top // 4
    while d >= 1:  # down-sweep
        idx = at(3 * d - 1, 2 * d)
        buf[..., idx, :, :] = buf[..., idx - d, :, :] @ buf[..., idx, :, :]
        d //= 2
    return _rows_markov_from_powers(buf, b, cy_c)


def prediction_matrices(model: LinearModel, horizon: int,
                        cy: Optional[Tensor] = None,
                        method: str = "dag") -> PredictionMatrices:
    """F1/F2 for a batch of models; ``cy`` selects tracked outputs of C z."""
    c = model.C
    cy_c = c if cy is None else cy @ c
    py, nz = cy_c.shape[-2], model.A.shape[-1]
    m = model.B.shape[-1]
    builds = {"dag": markov_dag, "doubling": markov_doubling,
              "assoc": markov_assoc, "scan": markov_scan}
    if method not in builds:
        raise ValueError(f"unknown markov method {method!r}; "
                         f"available: {sorted(builds)}")
    rows, markov = builds[method](model.A, model.B, cy_c, horizon)
    batch = rows.shape[:-3]
    f1 = rows.reshape(batch + (horizon * py, nz))
    # F2[i, j] = markov[i - j] for i >= j (block indices), else 0
    idx = torch.arange(horizon, device=c.device)
    diff = idx[:, None] - idx[None, :]
    mask = (diff >= 0).to(markov.dtype)
    blocks = markov[..., diff.clamp(0, horizon - 1), :, :]  # (..., N, N, py, m)
    blocks = blocks * mask[:, :, None, None]
    f2 = blocks.transpose(-3, -2).reshape(batch + (horizon * py, horizon * m))
    return PredictionMatrices(f1=f1, f2=f2)


def augment_delta_u(model: LinearModel) -> LinearModel:
    """Incremental-input augmentation (``Tank_System.m:107-112``): the
    state becomes [z; u] and the decision du,
    A <- [A B; 0 I], B <- [B; I], C <- [C 0]."""
    a, b, c = model
    nz, m = b.shape[-2], b.shape[-1]
    batch = a.shape[:-2]
    kw = dict(dtype=a.dtype, device=a.device)
    eye = torch.eye(m, **kw).expand(batch + (m, m))
    a_aug = torch.cat([torch.cat([a, b], dim=-1),
                       torch.cat([torch.zeros(batch + (m, nz), **kw), eye],
                                 dim=-1)], dim=-2)
    b_aug = torch.cat([b, eye], dim=-2)
    c_aug = torch.cat([c, torch.zeros(c.shape[:-1] + (m,), **kw)], dim=-1)
    return LinearModel(A=a_aug, B=b_aug, C=c_aug)


def block_diag_repeat(block: Tensor, horizon: int) -> Tensor:
    """``kron(I_N, block)`` for a batch of (..., k, k) blocks."""
    k = block.shape[-1]
    eye = torch.eye(horizon, dtype=block.dtype, device=block.device)
    out = eye[:, None, :, None] * block[..., None, :, None, :]
    return out.reshape(block.shape[:-2] + (horizon * k, horizon * k))


def weight_bar(q_block: Tensor, horizon: int,
               terminal: Optional[Tensor] = None) -> Tensor:
    """``Qbar = kron(I_N, Q)``, its last (py, py) block replaced by
    ``terminal`` when given (``Revise_2/Koopman_update.m:379-381`` injects
    C P C', ``VDP_Revise_2`` the full P). Under terminal synthesis the
    terminal block is per scenario, so Qbar is (B, N*py, N*py) even where
    ``q_block`` is shared."""
    qbar = block_diag_repeat(q_block, horizon)
    if terminal is None:
        return qbar
    py = q_block.shape[-1]
    shape = torch.broadcast_shapes(qbar.shape, terminal.shape[:-2] + (1, 1))
    if qbar.shape != shape:  # a shared Q: one copy per scenario
        qbar = qbar.expand(shape).clone()
    qbar[..., -py:, -py:] = terminal
    return qbar


def condensed_qp(pred: PredictionMatrices, z0: Tensor, yr: Tensor,
                 qbar: Tensor, rbar: Tensor, u_min: Tensor, u_max: Tensor,
                 a_ineq: Optional[Tensor] = None,
                 l_ineq: Optional[Tensor] = None,
                 u_ineq: Optional[Tensor] = None):
    """The condensed QP: H = F2' Qbar F2 + Rbar, symmetrized
    (Tank_System.m:152-153); P = 2H; q = 2 F2' Qbar (F1 z0 - yr).
    ``z0`` (..., nz), ``yr`` (..., N*py), bounds (..., N*m).

    Without ``a_ineq`` it is the box QP (:class:`BoxQP`, A = I). With
    extra rows ``l_ineq <= a_ineq x <= u_ineq`` it is the general
    :class:`QPData` whose A stacks the identity rows first, then
    ``a_ineq``; A keeps a batch axis only where ``a_ineq`` has one."""
    f1, f2 = pred
    f2t = f2.transpose(-1, -2)
    h = (f2t @ qbar) @ f2 + rbar
    h = 0.5 * (h + h.transpose(-1, -2))
    err = (f1 @ z0.unsqueeze(-1)).squeeze(-1) - yr
    q = 2.0 * (f2t @ (qbar @ err.unsqueeze(-1))).squeeze(-1)
    nx = f2.shape[-1]
    lo = u_min.expand(f2.shape[:-2] + (nx,))
    hi = u_max.expand(f2.shape[:-2] + (nx,))
    if a_ineq is None:
        return BoxQP(P=2.0 * h, q=q, l=lo, u=hi)
    eye = torch.eye(nx, dtype=f2.dtype, device=f2.device)
    batch = a_ineq.shape[:-2]
    a = torch.cat([eye.expand(batch + (nx, nx)), a_ineq], dim=-2)
    return QPData(P=2.0 * h, q=q, A=a, l=torch.cat([lo, l_ineq], dim=-1),
                  u=torch.cat([hi, u_ineq], dim=-1))
