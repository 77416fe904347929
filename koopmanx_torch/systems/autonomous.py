"""Autonomous and offline data generators on the host (the port's own copy
of ``koopmanx/systems/autonomous.py``, which is NumPy and SciPy only).

The KMAE training file's ``solve_ivp`` generators
(``DeepLearning_KoopmanControl_Approach3.py:17-38``: ``ez_example_solve``,
``duffing_solve``, LSODA over batches of random initial conditions) and
its pure-EDMD LTI ``snapshots`` helper (:187-199). They prepare data
once, on the host; the control-path RK4 collection is
:mod:`koopmanx_torch.systems.data`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def ez_example_field(t, x):
    """The training file's warm-up system (``ez_example``, :18-22):
    dx1 = -0.1 x1, dx2 = x2 - x1^2 (one stable and one unstable mode with
    a quadratic coupling — the classic linearizable Koopman testcase)."""
    x1, x2 = x[0], x[1]
    return np.array([-0.1 * x1, x2 - x1**2])


def duffing_autonomous_field(t, x):
    """Unforced Duffing (``duffing_example``, :28-32)."""
    x1, x2 = x[0], x[1]
    return np.array([x2, -0.5 * x2 + x1 - x1**3])


def autonomous_rollout_ivp(
    field: Callable,
    x0: np.ndarray,
    t_span: Tuple[float, float],
    n_eval: int,
    method: str = "LSODA",
    rtol: float = 1e-3,
    atol: float = 1e-6,
) -> np.ndarray:
    """Batch of adaptive-solver rollouts: ``x0`` (B, n) initial conditions
    -> (B, n_eval, n) trajectories sampled on ``linspace(*t_span, n_eval)``
    (the reference's ``solve_ivp(..., method='LSODA', t_eval=tspan)``
    per-IC loop, :23-25/:36-37). ``rtol``/``atol`` default to scipy's
    (the reference runs defaults); tighten for integrator cross-checks."""
    from scipy.integrate import solve_ivp

    t_eval = np.linspace(t_span[0], t_span[1], n_eval)
    out = np.empty((x0.shape[0], n_eval, x0.shape[1]), dtype=np.float64)
    for i, ic in enumerate(np.asarray(x0, dtype=np.float64)):
        sol = solve_ivp(
            field, t_span, y0=ic, method=method, t_eval=t_eval,
            rtol=rtol, atol=atol,
        )
        out[i] = sol.y.T
    return out


def ez_example_solve(
    n_traj: int = 1000, n_eval: int = 10, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """``ez_example_solve`` (:17-25): 10-sample LSODA rollouts over ``n_traj``
    uniform ICs in [-5, 5]^2. Returns (n_traj, n_eval, 2)."""
    rng = np.random.default_rng() if rng is None else rng
    x0 = 10.0 * rng.random((n_traj, 2)) - 5.0
    return autonomous_rollout_ivp(ez_example_field, x0, (0.0, 1.0), n_eval)


def duffing_solve(
    n_traj: int = 1000, n_eval: int = 11, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """``duffing_solve`` (:27-38): 11-sample LSODA rollouts of the unforced
    Duffing over uniform ICs in [-2, 2]^2. Returns (n_traj, n_eval, 2)."""
    rng = np.random.default_rng() if rng is None else rng
    x0 = rng.uniform(-2.0, 2.0, size=(n_traj, 2))
    return autonomous_rollout_ivp(
        duffing_autonomous_field, x0, (0.0, 2.75), n_eval
    )


def pairs_from_rollouts(traj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Stack (x_k, x_{k+1}) snapshot pairs from (B, T, n) rollouts —
    the reshaping the reference does inline before its pure-EDMD fit."""
    x = traj[:, :-1].reshape(-1, traj.shape[-1])
    y = traj[:, 1:].reshape(-1, traj.shape[-1])
    return x, y


def lti_snapshots(
    n_pairs: int,
    j: Optional[Sequence[Sequence[float]]] = None,
    box: Tuple[float, float] = (-5.0, 5.0),
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The pure-EDMD LTI sanity snapshots (``snapshots``, :187-199):
    one-step pairs y = J x of the fixed stable map
    J = [[0.9, -0.1], [0, 0.8]] over uniform states in ``box``. EDMD with
    the identity dictionary must recover J exactly (rank-2 data)."""
    rng = np.random.default_rng() if rng is None else rng
    j = np.array([[0.9, -0.1], [0.0, 0.8]]) if j is None else np.asarray(j)
    n = j.shape[0]
    x = (box[1] - box[0]) * rng.random((n_pairs, n)) + box[0]
    y = x @ j.T
    return x, y
