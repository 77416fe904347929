"""Batched box-QP ADMM: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``koopmanx/ops/qp_pallas_box.py::box_admm_pallas``
with ``koopmanx_torch/csrc/box_admm.cu`` (one warp per scenario, lane i
holding row i of the KKT inverse in registers for nx <= 32, the inverse
in shared memory above; see the note at the top of the source for its
bound and design).

- :func:`box_admm_reference` is the plain PyTorch version: the same
  iteration as batched tensor ops.
- :func:`box_admm` dispatches on the tensors' device: a CPU tensor goes to
  the plain version, a CUDA tensor to the kernel, or the call raises.
  ``box_admm.launches`` counts kernel launches. It has no gradient, as the
  JAX package's Pallas route has none: under autograd it raises
  (:func:`refuse_autograd`) on every device.
- :func:`launch_shape` says how the kernel fills the card at a shape.

Signature of both: ``(minv, q, lo, hi, x0, y0, rho, iters, sigma, alpha)
-> (xt, z, y)`` with minv (B, nx, nx), vectors (B, nx), rho (B,).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch
from torch import Tensor

from . import build

_MAX_NX = 128  # the kernel keeps ceil(nx / 32) <= 4 rows per lane


class BoxADMMOut(NamedTuple):
    xt: Tensor  # (B, nx) final unprojected iterate
    z: Tensor  # (B, nx) projected (feasible) solution
    y: Tensor  # (B, nx) dual


def box_admm_reference(minv: Tensor, q: Tensor, lo: Tensor, hi: Tensor,
                       x0: Tensor, y0: Tensor, rho: Tensor, iters: int = 60,
                       sigma: float = 1e-6, alpha: float = 1.6) -> BoxADMMOut:
    """The plain PyTorch version of the kernel (same iteration as
    ``koopmanx/control/qp.py::solve_box_qp``, batched)."""
    rho_c = rho[:, None]
    x, y = x0, y0
    z = torch.clamp(x, lo, hi)
    for _ in range(iters):
        rhs = sigma * x - q + rho_c * z - y
        xt = (minv @ rhs.unsqueeze(-1)).squeeze(-1)
        x_mid = alpha * xt + (1.0 - alpha) * z
        z_new = torch.clamp(x_mid + y / rho_c, lo, hi)
        y = y + rho_c * (x_mid - z_new)
        x, z = xt, z_new
    return BoxADMMOut(xt=x, z=z, y=y)


_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.ensure_built("box_admm")))
            args = [ctypes.c_void_p] * 10 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
            ]
            for fn in (lib.box_admm_f32, lib.box_admm_f64):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.box_admm_launch_shape.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.box_admm_launch_shape.restype = ctypes.c_int
            lib.box_admm_error_string.argtypes = [ctypes.c_int]
            lib.box_admm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(minv: Tensor, vecs, rho: Tensor, iters: int) -> None:
    dev, dtype = minv.device, minv.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"box_admm takes float32 or float64, got {dtype}")
    if minv.dim() != 3 or minv.shape[1] != minv.shape[2]:
        raise ValueError(f"minv must be (B, nx, nx), got {tuple(minv.shape)}")
    b, nx = minv.shape[0], minv.shape[1]
    if nx > _MAX_NX:
        raise ValueError(f"box_admm kernel takes nx <= {_MAX_NX}, got {nx}")
    if rho.shape != (b,):
        raise ValueError(f"rho must be ({b},), got {tuple(rho.shape)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    for name, t in (("minv", minv), ("rho", rho), *vecs.items()):
        if name in vecs and t.shape != (b, nx):
            raise ValueError(f"{name} must be ({b}, {nx}), got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, minv on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, minv is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def refuse_autograd(*tensors, kernel: str = "box-ADMM") -> None:
    """Raise ``ValueError`` where grad mode is on and one of ``tensors``
    (None skipped) requires grad: the kernel route (of the ``kernel``
    named in the message) has no gradient, as the JAX package's Pallas
    route has none. The differentiable route is the plain one,
    ``qp_backend='xla'``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"the {kernel} kernel route has no gradient (nor has the JAX "
            "package's Pallas route): differentiate the closed loop on "
            "qp_backend='xla'")


def box_admm(minv: Tensor, q: Tensor, lo: Tensor, hi: Tensor, x0: Tensor,
             y0: Tensor, rho: Tensor, iters: int = 60, sigma: float = 1e-6,
             alpha: float = 1.6) -> BoxADMMOut:
    """Run ``iters`` box-ADMM iterations for a batch of QPs.

    On CPU tensors this is :func:`box_admm_reference`. On CUDA tensors it
    launches the kernel on the current stream, or raises on a wrong
    device, dtype, shape or contiguity, or a failed launch; it never falls
    back. On every device it raises ``ValueError`` under autograd
    (:func:`refuse_autograd`) rather than return a result without a
    graph."""
    refuse_autograd(minv, q, lo, hi, x0, y0, rho)
    if minv.device.type == "cpu":
        return box_admm_reference(minv, q, lo, hi, x0, y0, rho, iters,
                                  sigma, alpha)
    if minv.device.type != "cuda":
        raise ValueError(f"box_admm runs on CPU or CUDA, got {minv.device}")
    vecs = {"q": q, "lo": lo, "hi": hi, "x0": x0, "y0": y0}
    _check(minv, vecs, rho, iters)
    lib = _load()
    fn = lib.box_admm_f32 if minv.dtype == torch.float32 else lib.box_admm_f64
    b, nx = q.shape
    xt, z, y = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(minv.device):
        stream = torch.cuda.current_stream(minv.device).cuda_stream
        err = fn(minv.data_ptr(), q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                 x0.data_ptr(), y0.data_ptr(), rho.data_ptr(), xt.data_ptr(),
                 z.data_ptr(), y.data_ptr(), b, nx, iters, float(sigma),
                 float(alpha), stream)
    if err != 0:
        msg = lib.box_admm_error_string(err).decode()
        raise RuntimeError(f"box_admm kernel launch failed: {msg} ({err})")
    box_admm.launches += 1
    return BoxADMMOut(xt=xt, z=z, y=y)


box_admm.launches = 0


class LaunchShape(NamedTuple):
    registers: int  # per thread, as ptxas allotted them
    warps_per_block: int
    resident_warps_per_sm: int
    waves: int  # rounds of resident blocks that cover the batch


def launch_shape(dtype: torch.dtype, batch: int, nx: int) -> LaunchShape:
    """How :func:`box_admm` launches the kernel at ``batch`` x ``nx`` on the
    current CUDA device (the kernel's own occupancy query; no launch)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"box_admm takes float32 or float64, got {dtype}")
    lib = _load()
    out = (ctypes.c_int * 4)()
    err = lib.box_admm_launch_shape(int(dtype == torch.float64), batch, nx,
                                    ctypes.addressof(out))
    if err != 0:
        msg = lib.box_admm_error_string(err).decode()
        raise RuntimeError(f"box_admm launch shape failed: {msg} ({err})")
    return LaunchShape(*out)
