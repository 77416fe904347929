"""The condensed box-QP build in one CUDA kernel.

``koopmanx_torch/csrc/qp_build.cu`` computes, for a batch of models
(A, B, CyC) with the state z, the reference window yr and the weights
(Q, R and, where given, a per-scenario terminal block), each scenario's
``P = 2 (0.5 (H + H'))`` with ``H = F2' Qbar F2 + Rbar`` and
``q = 2 F2' Qbar (F1 z - yr)`` in one launch: the arithmetic of
:func:`plain` (see the note at the top of the source for its bound and
design). It replaces no Pallas kernel: the JAX package leaves the build
to XLA. The engine takes it in ``engine/core.py::make_control_solver`` on
``qp_backend='pallas'``'s box path with ``markov='dag'`` where
:func:`supported` holds.

- :func:`qp_build` checks its inputs, then on a CUDA device launches the
  kernel on the current stream inside an operator-scope profiler record
  ``kx.qp_build_kernel`` (always on, so that a profiler puts the kernel
  under the range open at its launch), and on the CPU runs :func:`plain`.
  It never falls back. ``qp_build.launches`` counts kernel launches. It
  has no gradient: under autograd it raises (the plain route,
  ``qp_backend='xla'``, is the differentiable one).
- :func:`supported` is the shape test: nz <= 32 states, nx = N m <= 32
  decisions, py <= 32 outputs and N py <= 128 stacked outputs. The
  library is built for one shape at its first use
  (``_build/libqp_build_kx_qpb_m<m>_kx_qpb_n<N>_kx_qpb_nz<nz>_kx_qpb_py<py>.so``).
- :func:`launch_shape` says how the kernel fills the card at a shape.

Signature: ``(a, b, cy_c, z, yr, q, r, terminal, horizon, f_clamp) ->
(P, q)`` with a (B, nz, nz), b (B, nz, m), cy_c (B, py, nz),
z (B, nz), yr (N, py) or (B, N, py), q (py, py) or (B, py, py), r (m, m)
or (B, m, m), terminal None, (py, py) or (B, py, py); P (B, N m, N m),
q (B, N m).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..control.condensed import (
    block_diag_repeat,
    clamp_prediction,
    condensed_qp,
    prediction_matrices,
    weight_bar,
)
from ..types import LinearModel
from . import build
from .box_admm import refuse_autograd

MAX_NZ = 32  # states
MAX_NX = 32  # decisions N m
MAX_PY = 32  # tracked outputs
MAX_NP = 128  # stacked outputs N py: F2' Qbar (nx x N py) in shared memory


def supported(nz: int, m: int, py: int, horizon: int) -> bool:
    """Whether the kernel takes nz states, m inputs, py tracked outputs
    and a horizon of ``horizon`` steps."""
    return (1 <= nz <= MAX_NZ and m >= 1 and 1 <= py <= MAX_PY
            and horizon >= 1 and horizon * m <= MAX_NX
            and horizon * py <= MAX_NP)


def plain(a: Tensor, b: Tensor, cy_c: Tensor, z: Tensor, yr: Tensor,
          q: Tensor, r: Tensor, terminal: Optional[Tensor], horizon: int,
          f_clamp: float) -> Tuple[Tensor, Tensor]:
    """(P, q) by the engine's own composition: ``weight_bar``,
    ``block_diag_repeat``, ``prediction_matrices(..., 'dag')``,
    ``clamp_prediction`` and ``condensed_qp``."""
    qbar = weight_bar(q, horizon, terminal)
    rbar = block_diag_repeat(r, horizon)
    pred = clamp_prediction(
        prediction_matrices(LinearModel(a, b, cy_c), horizon, None, "dag"),
        f_clamp)
    no_bound = z.new_zeros(())
    qp = condensed_qp(pred, z, yr.flatten(-2), qbar, rbar, no_bound, no_bound)
    return qp.P, qp.q


_libs = {}
_lib_lock = threading.Lock()


def _defines(nz: int, m: int, py: int, horizon: int):
    return {"KX_QPB_NZ": nz, "KX_QPB_M": m, "KX_QPB_PY": py,
            "KX_QPB_N": horizon}


def _open(path) -> ctypes.CDLL:
    """A built library with its functions' argument and result types."""
    lib = ctypes.CDLL(str(path))
    args = ([ctypes.c_void_p] * 11 + [ctypes.c_double] + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
    for fn in (lib.qp_build_f32, lib.qp_build_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.qp_build_shape.argtypes = [ctypes.c_void_p]
    lib.qp_build_shape.restype = None
    lib.qp_build_launch_shape.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.qp_build_launch_shape.restype = ctypes.c_int
    lib.qp_build_error_string.argtypes = [ctypes.c_int]
    lib.qp_build_error_string.restype = ctypes.c_char_p
    return lib


def _load(nz: int, m: int, py: int, horizon: int) -> ctypes.CDLL:
    """The library built for this shape (built at its first use)."""
    key = (nz, m, py, horizon)
    with _lib_lock:
        lib = _libs.get(key)
        if lib is None:
            path = build.ensure_built("qp_build", _defines(*key))
            lib = _open(path)
            built = (ctypes.c_int * 4)()
            lib.qp_build_shape(ctypes.addressof(built))
            if tuple(built) != key:
                raise RuntimeError(f"{path} is built for (nz, m, py, N) = "
                                   f"{tuple(built)}, not {key}")
            _libs[key] = lib
        return lib


def _strides(name: str, t: Tensor, batch: int, rows: int, cols: int
             ) -> Tuple[int, int, int]:
    """(batch, row, column) element strides of a (rows, cols) or
    (batch, rows, cols) tensor; a shared matrix has batch stride 0."""
    if t.dim() == 2 and t.shape == (rows, cols):
        return (0,) + t.stride()
    if t.dim() == 3 and t.shape == (batch, rows, cols):
        return t.stride()
    raise ValueError(f"{name} must be ({rows}, {cols}) or "
                     f"({batch}, {rows}, {cols}), got {tuple(t.shape)}")


def _check(a, b, cy_c, z, yr, q, r, terminal, horizon):
    """The element strides the kernel reads (any layout), or raise on a
    wrong dtype, device or shape."""
    dtype, dev = a.dtype, a.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qp_build takes float32 or float64, got {dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.dim() != 3 \
            or b.shape[:2] != a.shape[:2]:
        raise ValueError(f"a must be (B, nz, nz) and b (B, nz, m), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, nz, m = a.shape[0], a.shape[1], b.shape[-1]
    if cy_c.dim() != 3 or cy_c.shape[0] != batch or cy_c.shape[2] != nz:
        raise ValueError(f"cy_c must be ({batch}, py, {nz}), got "
                         f"{tuple(cy_c.shape)}")
    py = cy_c.shape[1]
    if batch < 1 or not supported(nz, m, py, horizon):
        raise ValueError(
            f"the qp_build kernel takes B >= 1, nz <= {MAX_NZ}, N m <= "
            f"{MAX_NX}, py <= {MAX_PY} and N py <= {MAX_NP}, got B = {batch},"
            f" (nz, m, py, N) = ({nz}, {m}, {py}, {horizon})")
    named = [("a", a), ("b", b), ("cy_c", cy_c), ("z", z), ("yr", yr),
             ("q", q), ("r", r)]
    if terminal is not None:
        named.append(("terminal", terminal))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, a is {dtype}")
    if z.shape != (batch, nz):
        raise ValueError(f"z must be ({batch}, {nz}), got {tuple(z.shape)}")
    strides = []
    for name, t, rows, cols in (("a", a, nz, nz), ("b", b, nz, m),
                                ("cy_c", cy_c, py, nz),
                                ("yr", yr, horizon, py), ("q", q, py, py),
                                ("r", r, m, m)):
        strides += _strides(name, t, batch, rows, cols)
    strides += (_strides("terminal", terminal, batch, py, py)
                if terminal is not None else (0, 0, 0))
    return strides + list(z.stride())


def qp_build(a: Tensor, b: Tensor, cy_c: Tensor, z: Tensor, yr: Tensor,
             q: Tensor, r: Tensor, terminal: Optional[Tensor], horizon: int,
             f_clamp: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Each scenario's (P, q) of the condensed box QP: on a CUDA device by
    one launch of the kernel, on the CPU by :func:`plain`.

    It raises ``ValueError`` under autograd, ``TypeError`` or
    ``ValueError`` on a dtype other than float32 or float64, inputs on two
    devices or of two dtypes, a wrong shape or a shape :func:`supported`
    refuses (it reads any layout), and ``RuntimeError`` on a failed
    launch; it never falls back."""
    refuse_autograd(a, b, cy_c, z, yr, q, r, terminal, kernel="QP-build")
    strides = _check(a, b, cy_c, z, yr, q, r, terminal, horizon)
    if a.device.type != "cuda":
        return plain(a, b, cy_c, z, yr, q, r, terminal, horizon, f_clamp)
    batch, nz, m = a.shape[0], a.shape[1], b.shape[-1]
    py, nx = cy_c.shape[-2], horizon * b.shape[-1]
    lib = _load(nz, m, py, horizon)
    fn = lib.qp_build_f32 if a.dtype == torch.float32 else lib.qp_build_f64
    p = a.new_empty((batch, nx, nx))
    qv = a.new_empty((batch, nx))
    held = (ctypes.c_longlong * len(strides))(*strides)
    term = terminal.data_ptr() if terminal is not None else None
    with torch.cuda.device(a.device), \
            torch._C._profiler._RecordFunctionFast("kx.qp_build_kernel"):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), cy_c.data_ptr(), z.data_ptr(),
                 yr.data_ptr(), q.data_ptr(), r.data_ptr(), term,
                 p.data_ptr(), qv.data_ptr(), ctypes.addressof(held),
                 float(f_clamp), batch, nz, m, py, horizon, stream)
    if err != 0:
        msg = lib.qp_build_error_string(err).decode()
        raise RuntimeError(f"qp_build kernel launch failed: {msg} ({err})")
    qp_build.launches += 1
    return p, qv


qp_build.launches = 0


class LaunchShape(NamedTuple):
    registers: int  # per thread, as ptxas allotted them
    warps_per_block: int
    resident_warps_per_sm: int
    waves: int  # rounds of resident blocks that cover the batch
    shared_bytes_per_warp: int
    scenarios_per_warp: int


def launch_shape(dtype: torch.dtype, batch: int, nz: int, m: int, py: int,
                 horizon: int) -> LaunchShape:
    """How :func:`qp_build` launches the kernel at ``batch`` scenarios of
    this shape on the current CUDA device (the kernel's own occupancy
    query; no launch)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"qp_build takes float32 or float64, got {dtype}")
    if not supported(nz, m, py, horizon):
        raise ValueError(f"the qp_build kernel does not take (nz, m, py, N)"
                         f" = ({nz}, {m}, {py}, {horizon})")
    lib = _load(nz, m, py, horizon)
    out = (ctypes.c_int * 6)()
    err = lib.qp_build_launch_shape(int(dtype == torch.float64), batch,
                                    ctypes.addressof(out))
    if err != 0:
        msg = lib.qp_build_error_string(err).decode()
        raise RuntimeError(f"qp_build launch shape failed: {msg} ({err})")
    return LaunchShape(*out)
