"""Core types (counterpart of ``koopmanx/types.py:24-97``).

Every leaf is a ``torch.Tensor`` with a leading scenario axis where the
engine batches (JAX batched the same types with ``vmap``).
"""
from __future__ import annotations

from typing import NamedTuple

from torch import Tensor


class LinearModel(NamedTuple):
    """Lifted linear predictor ``z+ = A z + B u``, ``y = C z``.

    Shapes (with leading batch dims): A (..., N, N), B (..., N, m),
    C (..., p, N).
    """

    A: Tensor
    B: Tensor
    C: Tensor


class QPSolution(NamedTuple):
    """Primal/dual solution and residuals of the batched ADMM solver."""

    x: Tensor
    z: Tensor
    y: Tensor
    primal_res: Tensor
    dual_res: Tensor
    iterations: int
