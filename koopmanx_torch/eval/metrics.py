"""Scalar metrics over logged series (counterpart of
``koopmanx/eval/metrics.py``): open-loop prediction RMSE
(duffing.py:341-343), closed-loop tracking MSE (Tank_System.m:294),
steady-state error (Revise_2/Koopman_update.m:477), mean model-update
norms (duffing.py:985-990). Each takes tensors (or arrays) and returns a
0-dim tensor.
"""
from __future__ import annotations

import torch
from torch import Tensor


def openloop_rmse(pred, truth) -> Tensor:
    """The reference's RMSE, ``||(pred - truth)/T||_2`` over the first state
    channel (duffing.py:341); pred, truth (T,)."""
    pred, truth = torch.as_tensor(pred), torch.as_tensor(truth)
    return torch.linalg.vector_norm((pred - truth) / pred.shape[0])


def rmse(pred, truth) -> Tensor:
    """Conventional RMSE."""
    d = torch.as_tensor(pred) - torch.as_tensor(truth)
    return torch.sqrt(torch.mean(d ** 2))


def tracking_mse(y, r) -> Tensor:
    """Mean over time of the squared tracking error summed over outputs;
    y, r (T,) or (T, py)."""
    d = torch.as_tensor(y) - torch.as_tensor(r)
    if d.dim() == 1:
        d = d[:, None]
    return torch.mean(torch.sum(d ** 2, dim=-1))


def steady_state_error(y, r, tail: int = 10) -> Tensor:
    """Mean |y - r| over the last ``tail`` steps."""
    y, r = torch.as_tensor(y), torch.as_tensor(r)
    return torch.mean(torch.abs(y[-tail:] - r[-tail:]))


def mean_update_norms(drift_a, drift_b, drift_c):
    return tuple(torch.mean(torch.as_tensor(d))
                 for d in (drift_a, drift_b, drift_c))
