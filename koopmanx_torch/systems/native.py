"""The native C++ plant over the port's ``System``s (the port's own copy
of ``koopmanx/systems/native.py``): each registry plant and both RK4
variants, stepped in float64 on the host, outside the torch program.

Hardware-in-the-loop serving (``tools/bench_hil_torch.py``) steps its
plant here while the controller runs on the card; the tests hold it
against the port's own integrators (``systems/base.py``). A plant the
library lacks, or a library that does not build, raises
:class:`NativeUnavailable`.
"""
from __future__ import annotations

import numpy as np

from ..ops.native import NativeUnavailable, as_c, f64, load
from .base import System

__all__ = ["NativeUnavailable", "native_step", "native_step_batch",
           "native_rollout", "supported"]

# name -> (id, state dim); the ids of csrc/plant_sim.cpp::kSpecs
_SYS = {
    "duffing": (0, 2),
    "vanderpol": (1, 2),
    "tank": (2, 2),
    "tank3": (3, 3),
    "pendulum": (4, 2),
    "toy1d": (5, 1),
    "approach3": (6, 2),
    "tank_mimo": (7, 2),
}
_INTEGRATOR = {"rk4": 0, "rk4_matlab": 1}


def supported(system: System) -> bool:
    return system.name in _SYS


def _ids(system: System, integrator: str):
    try:
        sys_id, n = _SYS[system.name]
    except KeyError:
        raise NativeUnavailable(f"no native plant for {system.name!r}")
    if integrator not in _INTEGRATOR:
        raise ValueError(f"unknown integrator {integrator!r}")
    return sys_id, n, _INTEGRATOR[integrator]


def _theta(system: System, theta, batch: int = 0) -> np.ndarray:
    """The parameters as the C side reads them: (ntheta,) shared, or with
    ``batch`` a (batch, ntheta) row per plant."""
    if len(theta) != len(system.theta0):
        raise ValueError(f"{system.name} takes {len(system.theta0)} "
                         f"parameters, got {len(theta)}")
    if batch:
        return f64(np.stack([_shaped("theta", f64(v), (batch,))
                             for v in theta], axis=1))
    return f64([float(v) for v in theta])


def _shaped(name: str, a: np.ndarray, shape) -> np.ndarray:
    """``a`` as ``shape`` (the C side reads exactly that many values), or
    ValueError."""
    if a.size != int(np.prod(shape)):
        raise ValueError(f"{name} has {a.size} values, the plant reads "
                         f"{tuple(shape)}")
    return f64(a.reshape(shape))


def native_step(system: System, x, u, theta, h: float,
                integrator: str = "rk4") -> np.ndarray:
    """One plant step of one state (n,) under input (m,), as
    ``systems.base.make_step(system, h, integrator)`` (clamp included);
    float64 out."""
    lib = load()
    sys_id, n, integ = _ids(system, integrator)
    xb, ub = _shaped("x", f64(x), (n,)), _shaped("u", f64(u), (system.m,))
    th = _theta(system, theta)
    out = np.zeros(n, dtype=np.float64)
    rc = lib.koopman_plant_step(sys_id, integ, float(h), as_c(th), as_c(xb),
                                as_c(ub), as_c(out))
    if rc != 0:
        raise NativeUnavailable(f"native plant step failed (rc={rc})")
    return out


def native_step_batch(system: System, x, u, theta, h: float,
                      integrator: str = "rk4",
                      per_plant_theta: bool = False) -> np.ndarray:
    """One step of a fleet of B plants: ``x`` (B, n), ``u`` (B, m) or (B,);
    ``theta`` one shared parameter tuple or, with ``per_plant_theta``, a
    tuple of (B,) arrays (one plant per row). float64 (B, n) out."""
    lib = load()
    sys_id, n, integ = _ids(system, integrator)
    xb = f64(x)
    b = xb.shape[0]
    xb, ub = _shaped("x", xb, (b, n)), _shaped("u", f64(u), (b, system.m))
    th = _theta(system, theta, b if per_plant_theta else 0)
    out = np.zeros((b, n), dtype=np.float64)
    rc = lib.koopman_plant_step_batch(sys_id, integ, float(h), b, as_c(th),
                                      1 if per_plant_theta else 0, as_c(xb),
                                      as_c(ub), as_c(out))
    if rc != 0:
        raise NativeUnavailable(f"native fleet step failed (rc={rc})")
    return out


def native_rollout(system: System, x0, u_seq, theta, h: float,
                   integrator: str = "rk4") -> np.ndarray:
    """A rollout from ``x0`` under ``u_seq`` (steps,) or (steps, m): the
    state after each step, (steps, n)."""
    lib = load()
    sys_id, n, integ = _ids(system, integrator)
    x0b = _shaped("x0", f64(x0), (n,))
    # (steps, m) with the system's input width: the C side reads
    # u_seq + t * m
    useq = f64(f64(u_seq).reshape(-1, system.m))
    steps = useq.shape[0]
    th = _theta(system, theta)
    out = np.zeros((steps, n), dtype=np.float64)
    rc = lib.koopman_plant_rollout(sys_id, integ, float(h), steps, as_c(th),
                                   as_c(x0b), as_c(useq), as_c(out))
    if rc != 0:
        raise NativeUnavailable(f"native plant rollout failed (rc={rc})")
    return out
