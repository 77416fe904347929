"""Reference-signal generators (counterpart of
``koopmanx/engine/ref.py:19-32``). ``ref_fn(step) -> (horizon, py)`` is the
receding window r_k .. r_{k+N-1}; the slice ports the constant reference."""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

RefFn = Callable[[int], Tensor]


def constant(value, horizon: int, py: int = 1,
             dtype: torch.dtype = torch.float32, device=None) -> RefFn:
    """r = const (r = 1 for Duffing, duffing.py:748)."""
    v = torch.as_tensor(value, dtype=dtype, device=device).expand(py)
    window = v.expand(horizon, py)

    def ref_fn(step: int) -> Tensor:
        del step
        return window

    return ref_fn
