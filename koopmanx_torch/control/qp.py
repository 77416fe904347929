"""Batched OSQP-style ADMM (counterpart of ``koopmanx/control/qp.py``:
``ADMMConfig`` and ``_effective_rho`` :36-68, ``solve_qp`` and
``solve_qp_batch`` :71-133, ``box_kkt`` :136-142, ``solve_box_qp``
:145-202 and ``solve_box_qp_batch_pallas`` :205-249).

  general:  minimize 1/2 x'Px + q'x   s.t.  l <= Ax <= u
  box:      minimize 1/2 x'Px + q'x   s.t.  lo <= x <= hi

The box functions take a leading scenario axis: p (B, nx, nx), vectors
(B, nx); :func:`solve_qp` takes any leading axes, none included. The KKT
matrix (``P + (sigma + rho) I``, or ``P + sigma I + rho A'A`` in general)
is inverted once per call (``ops/linalg.spd_inverse`` at ``kkt_block``, on
every route; the plain box path also takes the caller's inverse, as the
engine's output-space construction gives it), then a fixed number of ADMM
iterations runs, as plain tensor ops or, for the box path, in the CUDA
kernel (:func:`solve_box_qp_batch_kernel`). Under ``kkt_bf16`` the
inverse is rounded to bfloat16 once (round to nearest even, as JAX's
``astype``) and read back in the working dtype, on every route: the
kernel reads that rounded inverse too, where the JAX package's TPU Pallas
route drops the flag (``koopmanx/control/qp.py:227-236``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from ..ops.box_admm import box_admm, box_admm_reference, refuse_autograd
from ..ops.linalg import spd_inverse
from ..types import QPData, QPSolution


class ADMMConfig(NamedTuple):
    iters: int = 100
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6
    kkt_block: int = 1  # KKT elimination block size (spd_inverse)
    # normalize rho by trace(P)/nx (JAX's field; last here so that the
    # box path's positional callers keep their meaning)
    scale_rho: bool = True
    # the KKT inverse rounded to bfloat16 (JAX's field; last, as above)
    kkt_bf16: bool = False


def _effective_rho(p: Tensor, cfg: ADMMConfig) -> Tensor:
    """rho per QP, shape ``p.shape[:-2]``: ``rho * max(trace(P)/nx, 1e-6)``,
    or ``rho`` itself without ``scale_rho``."""
    if not cfg.scale_rho:
        return torch.full(p.shape[:-2], cfg.rho, dtype=p.dtype, device=p.device)
    nx = p.shape[-1]
    scale = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1) / nx
    return cfg.rho * torch.clamp(scale, min=1e-6)


def box_kkt(p: Tensor, cfg: ADMMConfig) -> Tensor:
    """The box-path KKT matrix P + (sigma + rho(P)) I."""
    nx = p.shape[-1]
    rho = _effective_rho(p, cfg)
    eye = torch.eye(nx, dtype=p.dtype, device=p.device)
    return p + (cfg.sigma + rho)[..., None, None] * eye


def bf16_rounded(kkt_inv: Tensor, cfg: ADMMConfig) -> Tensor:
    """``kkt_inv`` rounded to bfloat16 and read back in its own dtype under
    ``cfg.kkt_bf16`` (JAX's ``astype(bfloat16)`` then ``astype(dtype)`` in
    the iteration), else ``kkt_inv`` itself."""
    if not cfg.kkt_bf16:
        return kkt_inv
    return kkt_inv.to(torch.bfloat16).to(kkt_inv.dtype)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def solve_qp(qp: QPData, cfg: ADMMConfig = ADMMConfig(),
             x0: Optional[Tensor] = None,
             y0: Optional[Tensor] = None) -> QPSolution:
    """Solve QPs with inequality rows by a fixed number of ADMM iterations
    (``koopmanx/control/qp.py::solve_qp``). Every leaf may carry the same
    leading batch axes (none: one QP); ``x0``/``y0`` warm-start the primal
    and dual iterates."""
    p, q, a, lo, hi = qp
    nx = p.shape[-1]
    x = torch.zeros_like(q) if x0 is None else x0
    y = torch.zeros_like(lo) if y0 is None else y0
    at = a.transpose(-1, -2)
    z = torch.clamp(_mv(a, x), lo, hi)
    rho = _effective_rho(p, cfg)[..., None]  # (..., 1)
    sigma, alpha = cfg.sigma, cfg.alpha
    eye = torch.eye(nx, dtype=p.dtype, device=p.device)
    kkt = p + sigma * eye + (rho[..., None] * at) @ a
    kkt_inv = bf16_rounded(spd_inverse(kkt, block=cfg.kkt_block), cfg)
    for _ in range(cfg.iters):
        rhs = sigma * x - q + _mv(at, rho * z - y)
        xt = _mv(kkt_inv, rhs)
        axt = _mv(a, xt)
        x = alpha * xt + (1.0 - alpha) * x
        z_mid = alpha * axt + (1.0 - alpha) * z
        z_new = torch.clamp(z_mid + y / rho, lo, hi)
        y = y + rho * (z_mid - z_new)
        z = z_new
    ax = _mv(a, x)
    primal = (ax - torch.clamp(ax, lo, hi)).abs().amax(-1)
    dual = (_mv(p, x) + q + _mv(at, y)).abs().amax(-1)
    return QPSolution(x=x, z=z, y=y, primal_res=primal, dual_res=dual,
                      iterations=cfg.iters)


def solve_qp_batch(qp: QPData, cfg: ADMMConfig = ADMMConfig(),
                   x0: Optional[Tensor] = None,
                   y0: Optional[Tensor] = None) -> QPSolution:
    """:func:`solve_qp` over a leading batch axis that every leaf carries
    (the counterpart of JAX's ``vmap``-ed ``solve_qp_batch``)."""
    if qp.P.dim() < 3:
        raise ValueError(f"P must be (B, nx, nx), got {tuple(qp.P.shape)}")
    return solve_qp(qp, cfg, x0, y0)


def _solve(admm, p, q, lo, hi, cfg: ADMMConfig, x0, y0, kkt_inv=None):
    x0 = torch.zeros_like(q) if x0 is None else x0
    y0 = torch.zeros_like(q) if y0 is None else y0
    rho = _effective_rho(p, cfg)
    if kkt_inv is None:
        kkt_inv = spd_inverse(box_kkt(p, cfg), block=cfg.kkt_block)
    out = admm(bf16_rounded(kkt_inv, cfg), q, lo, hi, x0, y0, rho,
               iters=cfg.iters, sigma=cfg.sigma, alpha=cfg.alpha)
    primal = (out.xt - torch.clamp(out.xt, lo, hi)).abs().amax(-1)
    dual = ((p @ out.z.unsqueeze(-1)).squeeze(-1) + q + out.y).abs().amax(-1)
    return QPSolution(
        x=out.z,  # the projected iterate is the feasible solution
        z=out.z,
        y=out.y,
        primal_res=primal,
        dual_res=dual,
        iterations=cfg.iters,
    )


def solve_box_qp(p: Tensor, q: Tensor, lo: Tensor, hi: Tensor,
                 cfg: ADMMConfig = ADMMConfig(), x0: Optional[Tensor] = None,
                 y0: Optional[Tensor] = None,
                 kkt_inv: Optional[Tensor] = None) -> QPSolution:
    """Box-constrained ADMM (A = I) as plain batched tensor ops: the
    counterpart of ``vmap(koopmanx.control.qp.solve_box_qp)``.
    ``kkt_inv``: the caller's inverse of :func:`box_kkt` (rho is still
    computed from ``p``; ``kkt_bf16`` rounds it here); None inverts
    here."""
    return _solve(box_admm_reference, p, q, lo, hi, cfg, x0, y0, kkt_inv)


def solve_box_qp_batch_kernel(p: Tensor, q: Tensor, lo: Tensor, hi: Tensor,
                              cfg: ADMMConfig = ADMMConfig(),
                              x0: Optional[Tensor] = None,
                              y0: Optional[Tensor] = None) -> QPSolution:
    """The same solve with the iterations in the box-ADMM kernel
    (counterpart of ``solve_box_qp_batch_pallas``): rho, the KKT inverse
    (rounded through bfloat16 under ``kkt_bf16``) and the residuals here,
    the iterations in :func:`box_admm`, which launches the CUDA kernel for
    CUDA tensors. Under autograd it raises ``ValueError`` before any of
    that, on every device: the kernel route has no gradient."""
    refuse_autograd(p, q, lo, hi, x0, y0)
    c = lambda t: None if t is None else t.contiguous()
    return _solve(box_admm, p, q.contiguous(), lo.contiguous(),
                  hi.contiguous(), cfg, c(x0), c(y0))


def make_box_qp_solver(cfg: ADMMConfig, backend: str = "xla"):
    """``solve(p, q, lo, hi, x0, y0)`` for a scenario batch: 'pallas'
    (the name kept from the JAX config) is the kernel route, 'xla' the
    plain one, which also takes a ``kkt_inv`` (JAX's ``solve_plain``;
    the kernel route inverts for itself, as JAX's Pallas route does)."""
    if backend == "pallas":
        return lambda p, q, lo, hi, x0, y0: solve_box_qp_batch_kernel(
            p, q, lo, hi, cfg, x0, y0)
    if backend == "xla":
        return lambda p, q, lo, hi, x0, y0, kkt_inv=None: solve_box_qp(
            p, q, lo, hi, cfg, x0, y0, kkt_inv)
    raise ValueError(f"unknown qp_backend {backend!r}")
