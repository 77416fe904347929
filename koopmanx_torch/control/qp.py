"""Batched box-QP ADMM (counterpart of ``koopmanx/control/qp.py``:
``ADMMConfig`` and ``_effective_rho`` :36-68, ``box_kkt`` :136-142,
``solve_box_qp`` :145-202 and ``solve_box_qp_batch_pallas`` :205-249).

  minimize 1/2 x'Px + q'x   s.t.  lo <= x <= hi

Every function takes a leading scenario axis: p (B, nx, nx), vectors
(B, nx). The KKT matrix ``P + (sigma + rho) I`` is inverted once per call
(``ops/linalg.spd_inverse`` at ``kkt_block``, on every route), then a fixed
number of ADMM iterations runs, either as plain tensor ops
(:func:`solve_box_qp`) or in the CUDA kernel (:func:`solve_box_qp_batch_kernel`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from ..ops.box_admm import box_admm, box_admm_reference
from ..ops.linalg import spd_inverse
from ..types import QPSolution


class ADMMConfig(NamedTuple):
    iters: int = 100
    rho: float = 1.0
    sigma: float = 1e-6
    alpha: float = 1.6
    kkt_block: int = 1  # KKT elimination block size (spd_inverse)


def _effective_rho(p: Tensor, cfg: ADMMConfig) -> Tensor:
    """Per-scenario rho (B,): ``rho * max(trace(P)/nx, 1e-6)``."""
    nx = p.shape[-1]
    scale = torch.diagonal(p, dim1=-2, dim2=-1).sum(-1) / nx
    return cfg.rho * torch.clamp(scale, min=1e-6)


def box_kkt(p: Tensor, cfg: ADMMConfig) -> Tensor:
    """The box-path KKT matrix P + (sigma + rho(P)) I."""
    nx = p.shape[-1]
    rho = _effective_rho(p, cfg)
    eye = torch.eye(nx, dtype=p.dtype, device=p.device)
    return p + (cfg.sigma + rho)[..., None, None] * eye


def _solve(admm, p, q, lo, hi, cfg: ADMMConfig, x0, y0):
    x0 = torch.zeros_like(q) if x0 is None else x0
    y0 = torch.zeros_like(q) if y0 is None else y0
    rho = _effective_rho(p, cfg)
    kkt_inv = spd_inverse(box_kkt(p, cfg), block=cfg.kkt_block)
    out = admm(kkt_inv, q, lo, hi, x0, y0, rho, iters=cfg.iters,
               sigma=cfg.sigma, alpha=cfg.alpha)
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
                 y0: Optional[Tensor] = None) -> QPSolution:
    """Box-constrained ADMM (A = I) as plain batched tensor ops: the
    counterpart of ``vmap(koopmanx.control.qp.solve_box_qp)``."""
    return _solve(box_admm_reference, p, q, lo, hi, cfg, x0, y0)


def solve_box_qp_batch_kernel(p: Tensor, q: Tensor, lo: Tensor, hi: Tensor,
                              cfg: ADMMConfig = ADMMConfig(),
                              x0: Optional[Tensor] = None,
                              y0: Optional[Tensor] = None) -> QPSolution:
    """The same solve with the iterations in the box-ADMM kernel
    (counterpart of ``solve_box_qp_batch_pallas``): rho, the KKT inverse
    and the residuals here, the iterations in :func:`box_admm`, which
    launches the CUDA kernel for CUDA tensors."""
    c = lambda t: None if t is None else t.contiguous()
    return _solve(box_admm, p, q.contiguous(), lo.contiguous(),
                  hi.contiguous(), cfg, c(x0), c(y0))


def make_box_qp_solver(cfg: ADMMConfig, backend: str = "xla"):
    """``solve(p, q, lo, hi, x0, y0)`` for a scenario batch: 'pallas'
    (the name kept from the JAX config) is the kernel route, 'xla' the
    plain one."""
    if backend == "pallas":
        return lambda p, q, lo, hi, x0, y0: solve_box_qp_batch_kernel(
            p, q, lo, hi, cfg, x0, y0)
    if backend == "xla":
        return lambda p, q, lo, hi, x0, y0: solve_box_qp(
            p, q, lo, hi, cfg, x0, y0)
    raise ValueError(f"unknown qp_backend {backend!r}")
