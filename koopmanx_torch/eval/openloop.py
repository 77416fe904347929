"""Open-loop multi-step prediction validation (counterpart of
``koopmanx/eval/openloop.py``; reference behaviour ``duffing.py:264-344``):
free-run the lifted linear model under the recorded inputs, decode with
``C z`` each step, re-encode from the true state every ``reencode_every``
steps (``duffing.py:303``), and report the RMSE against the truth. JAX
scanned over steps; here it is a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..lifts.base import Dictionary
from ..types import LinearModel


class OpenLoopResult(NamedTuple):
    y_pred: Tensor  # (T, p) decoded predictions
    z_traj: Tensor  # (T, nlift) the lifted free run
    rmse_ref: Tensor  # the reference's RMSE formula on channel 0
    rmse: Tensor  # conventional RMSE over the predicted channels


def openloop_validate(model: LinearModel, dictionary: Dictionary,
                      x_truth: Tensor, u_seq: Tensor,
                      reencode_every: int = 0) -> OpenLoopResult:
    """``x_truth`` (T, n) true states, the first the initial one; ``u_seq``
    (T, m); one unbatched ``model``."""
    steps = x_truth.shape[0]
    ys, zs = [], []
    with torch.inference_mode():
        z = dictionary(x_truth[0])
        for step in range(steps):
            if reencode_every and step % reencode_every == 0:
                z = dictionary(x_truth[step])
            ys.append(model.C @ z)
            zs.append(z)
            z = model.A @ z + model.B @ u_seq[step]
        y_pred, z_traj = torch.stack(ys), torch.stack(zs)
        rmse_ref = torch.linalg.vector_norm((y_pred[:, 0] - x_truth[:, 0])
                                            / steps)
        rmse = torch.sqrt(torch.mean(
            (y_pred - x_truth[:, : y_pred.shape[1]]) ** 2))
    return OpenLoopResult(y_pred=y_pred, z_traj=z_traj, rmse_ref=rmse_ref,
                          rmse=rmse)
