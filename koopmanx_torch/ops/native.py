"""ctypes bindings to the repository's native C++ plant simulator and
exact box-QP solver (the port's own copy of ``koopmanx/ops/native.py``).

The library is built with ``g++`` at first use from ``csrc/plant_sim.cpp``
and ``csrc/boxqp.cpp`` (read as they are) into
``koopmanx_torch/_build/libkoopmanx_native.so``, and rebuilt when a source
is newer. A failed build or load raises :class:`NativeUnavailable`; no
caller of the port falls back to another plant.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from .build import BUILD_DIR, PKG_DIR

CSRC = PKG_DIR.parent / "csrc"
SOURCES = ("boxqp.cpp", "plant_sim.cpp")
LIB_PATH = BUILD_DIR / "libkoopmanx_native.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((CSRC / s).stat().st_mtime > built for s in SOURCES)


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           *(str(CSRC / s) for s in SOURCES), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"g++ failed: {e.stderr}") from e
    except OSError as e:
        raise NativeUnavailable(f"could not run g++: {e}") from e
    os.replace(tmp, LIB_PATH)


def load() -> ctypes.CDLL:
    """The native library, built first where it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not all((CSRC / s).exists() for s in SOURCES):
            raise NativeUnavailable(f"the C++ sources are not in {CSRC}")
        if _stale():
            _build()
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError as e:
            raise NativeUnavailable(f"could not load {LIB_PATH}: {e}") from e
        dp = ctypes.POINTER(ctypes.c_double)
        i, d = ctypes.c_int, ctypes.c_double
        for name, args in (
                ("boxqp_solve", [i, dp, dp, dp, dp, dp, i]),
                ("boxqp_solve_batch", [i, i, dp, dp, dp, dp, dp, i]),
                ("koopman_plant_dim", [i]),
                ("koopman_plant_step", [i, i, d, dp, dp, dp, dp]),
                ("koopman_plant_step_batch", [i, i, d, i, dp, i, dp, dp, dp]),
                ("koopman_plant_rollout", [i, i, d, i, dp, dp, dp, dp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        _lib = lib
        return lib


def as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def f64(a) -> np.ndarray:
    """A contiguous float64 host copy of an array or tensor."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def boxqp_solve(p, q, lo, hi, max_iter: int = 200) -> np.ndarray:
    """Exact box-QP solve, min 1/2 x'Px + q'x s.t. lo <= x <= hi, in
    float64 on the host: one problem (P (n, n)) or a batch (P (B, n, n)).
    Raises RuntimeError for a singular free block (P not SPD)."""
    lib = load()
    p, q = f64(p), f64(q)
    n = p.shape[-1]
    if p.ndim not in (2, 3) or p.shape[-2] != n or q.shape != p.shape[:-1]:
        raise ValueError(f"P {p.shape} and q {q.shape}: want (n, n) and "
                         "(n,), or (B, n, n) and (B, n)")
    lo_b = f64(np.broadcast_to(f64(lo), q.shape))
    hi_b = f64(np.broadcast_to(f64(hi), q.shape))
    x = np.zeros(q.shape, dtype=np.float64)
    args = (as_c(p), as_c(q), as_c(lo_b), as_c(hi_b), as_c(x), max_iter)
    rc = (lib.boxqp_solve(n, *args) if p.ndim == 2
          else lib.boxqp_solve_batch(p.shape[0], n, *args))
    if rc == 2:
        raise RuntimeError("boxqp: singular free block (P not SPD?)")
    return x


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
        return True
    except NativeUnavailable:
        return False
