"""Result bundles and checkpoints (counterpart of
``koopmanx/eval/persist.py``).

:func:`archive_run` writes a closed-loop log as ``.npz`` under the JAX
package's keys and, with ``mat=True``, as ``<path>.mat`` under the
reference's key names (``duffing.py:1015``). :func:`save_pytree` and
:func:`load_pytree` checkpoint the port's state trees (a ``LoopCarry``, a
``ControllerState``: NamedTuples and tuples of tensors, with ``None`` and
``()`` holding no leaf) as flattened leaves, for checkpoint and resume.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..tree import host_numpy, tree_leaves, tree_unflatten


def save_pytree(path: str, tree: Any, meta: int = 0) -> None:
    """Write every tensor leaf of ``tree`` to ``path`` (``.npz``)."""
    leaves = tree_leaves(tree)
    np.savez(path, __meta__=meta, __n_leaves__=len(leaves),
             **{f"leaf_{i}": host_numpy(leaf) for i, leaf in enumerate(leaves)})


def load_pytree(path: str, template: Any) -> Tuple[Any, int]:
    """A tree saved by :func:`save_pytree`, in the structure of
    ``template`` with each leaf in its template leaf's dtype and on its
    device; returns (tree, meta)."""
    with np.load(path) as data:
        n = int(data["__n_leaves__"])
        arrays = [data[f"leaf_{i}"] for i in range(n)]
        meta = int(data["__meta__"])
    like = tree_leaves(template)
    if len(like) != n:
        raise ValueError(f"{path} holds {n} leaves, the template {len(like)}")
    leaves = [torch.from_numpy(a).to(dtype=t.dtype, device=t.device)
              for a, t in zip(arrays, like)]
    return tree_unflatten(template, leaves), meta


_REVISE2 = ("gamma", "eps_state", "eps_op", "compensator", "gamma_margin",
            "compare_state", "minus_set", "ellipse")


def archive_run(path: str, log, h: float = 0.05, mat: bool = False) -> None:
    """Write one scenario's StepLog (T, ...) as a results bundle: ``.npz``
    always; with ``mat=True`` also ``<path>.mat`` with the reference's key
    vocabulary (logX (n, T), logR, T_EX, A_error/B_error/C_error, tspan,
    and the Revise_2 collections, Koopman_update.m:251-254, :369-387)."""
    arrays = {k: host_numpy(getattr(log, k)) for k in (
        "x", "u", "r", "drift_a", "drift_b", "drift_c", "residual",
        "qp_primal_res", "lyapunov")}
    t = arrays["x"].shape[0]
    tspan = h * np.arange(t)
    arrays["tspan"] = tspan
    arrays.update({k: host_numpy(getattr(log, k)) for k in _REVISE2})
    np.savez(path, **arrays)
    if mat:
        import scipy.io as sio

        sio.savemat(str(path) + ".mat", {
            "tspan": tspan,
            "logX": arrays["x"].T,  # the reference stores states by column
            "logU": arrays["u"].T,
            "logR": arrays["r"].T,
            "T_EX": tspan,
            "A_error": arrays["drift_a"],
            "B_error": arrays["drift_b"],
            "C_error": arrays["drift_c"],
            "epsilon_Set": arrays["eps_state"],
            "V_Set": arrays["lyapunov"],
            "Gamma_Collection": arrays["gamma"],
            "Gamma_Set": arrays["gamma_margin"],
            "Compensator": arrays["compensator"].T,
            "Compare_State": arrays["compare_state"],
            "Minus_Set": arrays["minus_set"],
        })
