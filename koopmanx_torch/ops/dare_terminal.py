"""The per-step terminal synthesis in one CUDA kernel.

``koopmanx_torch/csrc/dare_terminal.cu`` computes, for a batch of models
(A, B) with the weights (Q, R), the DARE's P by 30 doubling steps, the
gain K = (R + B'PB)^-1 B'PA and gamma = trace P in one launch: the
arithmetic of ``control/dare.py::solve_dare_doubling`` and ``dlqr_gain``
with ``ops/linalg.py``'s pivoted and pivot-free Gauss-Jordan inverses
(see the note at the top of the source for its bound and design). It
replaces no Pallas kernel: the JAX package leaves the synthesis to XLA.
Its plain version is ``control/terminal.py::synthesize_terminal``'s plain
route, which also decides where the kernel runs.

- :func:`dare_terminal` checks its inputs, then launches the kernel on the
  current stream of their CUDA device, inside an operator-scope profiler
  record ``kx.dare_terminal`` (always on, so that a profiler puts the
  kernel under the range open at its launch). It never falls back.
  ``dare_terminal.launches`` counts kernel launches. It has no gradient:
  under autograd it raises (the plain route, ``qp_backend='xla'``, is the
  differentiable one).
- :func:`supported` is the shape test of the kernel route: nz <= 32 states
  and m <= 4 inputs. The library is built for one nz at its first use
  (``_build/libdare_terminal_kx_dare_nz<nz>.so``).
- :func:`launch_shape` says how the kernel fills the card at a shape.

Signature: ``(a, b, q, r, iters) -> (p, k, gamma)`` with a (B, nz, nz),
b (B, nz, m), q (nz, nz) or (B, nz, nz), r (m, m) or (B, m, m); p
(B, nz, nz), k (B, m, nz) with u = -K z, gamma (B,).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from . import build
from .box_admm import refuse_autograd

MAX_NZ = 32  # a lane a row: a segment of nz lanes inside one warp
MAX_M = 4  # the gain's m x m inverse unrolled in registers


def supported(nz: int, m: int) -> bool:
    """Whether the kernel takes nz states and m inputs."""
    return 1 <= nz <= MAX_NZ and 1 <= m <= MAX_M


_libs = {}
_lib_lock = threading.Lock()


def _open(path) -> ctypes.CDLL:
    """A built library with its functions' argument and result types."""
    lib = ctypes.CDLL(str(path))
    args = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.dare_terminal_f32, lib.dare_terminal_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.dare_terminal_width.argtypes = []
    lib.dare_terminal_width.restype = ctypes.c_int
    lib.dare_terminal_launch_shape.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dare_terminal_launch_shape.restype = ctypes.c_int
    lib.dare_terminal_error_string.argtypes = [ctypes.c_int]
    lib.dare_terminal_error_string.restype = ctypes.c_char_p
    return lib


def _load(nz: int) -> ctypes.CDLL:
    """The library built for width ``nz`` (built at its first use)."""
    with _lib_lock:
        lib = _libs.get(nz)
        if lib is None:
            path = build.ensure_built("dare_terminal", {"KX_DARE_NZ": nz})
            lib = _open(path)
            if lib.dare_terminal_width() != nz:
                raise RuntimeError(f"{path} is built for nz = "
                                   f"{lib.dare_terminal_width()}, not {nz}")
            _libs[nz] = lib
        return lib


def _matrix_strides(name: str, t: Tensor, batch: int, rows: int, cols: int
                    ) -> Tuple[int, int]:
    """(batch stride, row stride) of a (rows, cols) or (batch, rows, cols)
    tensor whose rows are unit-stride; a shared matrix has batch stride 0."""
    if t.dim() == 2 and t.shape == (rows, cols):
        bs, rs, cs = 0, t.stride(0), t.stride(1)
    elif t.dim() == 3 and t.shape == (batch, rows, cols):
        bs, rs, cs = t.stride()
    else:
        raise ValueError(f"{name} must be ({rows}, {cols}) or "
                         f"({batch}, {rows}, {cols}), got {tuple(t.shape)}")
    if (cols > 1 and cs != 1) or min(bs, rs) < 0:
        raise ValueError(f"{name} must have unit-stride rows, got strides "
                         f"{t.stride()}")
    return bs, rs


def _check(a: Tensor, b: Tensor, q: Tensor, r: Tensor, iters: int):
    """The element strides the kernel reads (A, B, Q, R: batch and row),
    or raise on a wrong dtype, device, shape or layout."""
    dtype, dev = a.dtype, a.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dare_terminal takes float32 or float64, got {dtype}")
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.dim() != 3:
        raise ValueError(f"a must be (B, nz, nz) and b (B, nz, m), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, nz, m = a.shape[0], a.shape[1], b.shape[-1]
    if batch < 1 or not supported(nz, m):
        raise ValueError(f"the dare_terminal kernel takes B >= 1, "
                         f"nz <= {MAX_NZ} and m <= {MAX_M}, got "
                         f"({batch}, {nz}, {m})")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    for name, t in (("a", a), ("b", b), ("q", q), ("r", r)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, a is {dtype}")
    strides = []
    for name, t, rows, cols in (("a", a, nz, nz), ("b", b, nz, m),
                                ("q", q, nz, nz), ("r", r, m, m)):
        strides += _matrix_strides(name, t, batch, rows, cols)
    return strides


def dare_terminal(a: Tensor, b: Tensor, q: Tensor, r: Tensor,
                  iters: int = 30) -> Tuple[Tensor, Tensor, Tensor]:
    """(P, K, gamma) of each scenario's model: P by ``iters`` doubling
    steps, K its gain (u = -K z), gamma = trace P, by one launch.

    It raises ``ValueError`` under autograd, ``TypeError`` or
    ``ValueError`` on a dtype other than float32 or float64, inputs on two
    devices or of two dtypes, a wrong shape, rows that are not
    unit-stride, or nz > 32 or m > 4, then ``ValueError`` on tensors that
    are not on a CUDA device, and ``RuntimeError`` on a failed launch; it
    never falls back."""
    refuse_autograd(a, b, q, r, kernel="terminal-synthesis")
    strides = _check(a, b, q, r, iters)
    if a.device.type != "cuda":
        raise ValueError(f"the dare_terminal kernel runs on a CUDA device, "
                         f"got {a.device}")
    batch, nz, m = a.shape[0], a.shape[1], b.shape[-1]
    lib = _load(nz)
    fn = lib.dare_terminal_f32 if a.dtype == torch.float32 else \
        lib.dare_terminal_f64
    p = a.new_empty((batch, nz, nz))
    k = a.new_empty((batch, m, nz))
    gamma = a.new_empty((batch,))
    held = (ctypes.c_longlong * 8)(*strides)
    with torch.cuda.device(a.device), \
            torch._C._profiler._RecordFunctionFast("kx.dare_terminal"):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
                 p.data_ptr(), k.data_ptr(), gamma.data_ptr(),
                 ctypes.addressof(held), batch, nz, m, iters, stream)
    if err != 0:
        msg = lib.dare_terminal_error_string(err).decode()
        raise RuntimeError(f"dare_terminal kernel launch failed: {msg} ({err})")
    dare_terminal.launches += 1
    return p, k, gamma


dare_terminal.launches = 0


class LaunchShape(NamedTuple):
    registers: int  # per thread, as ptxas allotted them
    warps_per_block: int
    resident_warps_per_sm: int
    waves: int  # rounds of resident blocks that cover the batch


def launch_shape(dtype: torch.dtype, batch: int, nz: int) -> LaunchShape:
    """How :func:`dare_terminal` launches the kernel at ``batch`` x ``nz``
    on the current CUDA device (the kernel's own occupancy query; no
    launch)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dare_terminal takes float32 or float64, got {dtype}")
    if not 1 <= nz <= MAX_NZ:
        raise ValueError(f"the dare_terminal kernel takes nz <= {MAX_NZ}, "
                         f"got {nz}")
    lib = _load(nz)
    out = (ctypes.c_int * 4)()
    err = lib.dare_terminal_launch_shape(int(dtype == torch.float64), batch,
                                         ctypes.addressof(out))
    if err != 0:
        msg = lib.dare_terminal_error_string(err).decode()
        raise RuntimeError(f"dare_terminal launch shape failed: {msg} ({err})")
    return LaunchShape(*out)
