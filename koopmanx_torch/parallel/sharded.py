"""Scenario fan-out and cross-rank reductions over the ``('data',)`` mesh
(counterpart of ``koopmanx/parallel/sharded.py``, whose ``shard_map``
bodies run here as each rank's own code on its block of rows):

  - :func:`sharded_closed_loop`: each rank runs the batched closed loop on
    its scenarios (:func:`.mesh.shard_batch`'s block); the loops do not
    interact, so no collective runs;
  - :func:`distributed_edmd_fit`: EDMD over a sharded snapshot set: local
    Grams, one ``all_reduce`` of them, then the small solve on every rank;
  - :func:`psum_mean`: the global mean of per-scenario values;
  - :func:`psum`: the differentiable sum over the mesh that the
    data-parallel KMAE step needs (``train/kmae.py``).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from ..edmd.batch import GramStats, fit_from_grams, gram_stats, lift_snapshots
from ..engine.loop import run_batch
from ..lifts.base import Dictionary
from ..systems.data import Snapshots
from ..types import LinearModel
from .mesh import DATA_AXIS, local_device


class _AllReduceSum(torch.autograd.Function):
    """``jax.lax.psum``: the sum over the group, whose transpose is again
    the sum over the group of the cotangents."""

    @staticmethod
    def forward(ctx, t: Tensor, group) -> Tensor:
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def psum(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over the ranks of ``group``, differentiable: its
    gradient is the sum over the group of each rank's cotangent."""
    return _AllReduceSum.apply(t, group)


def psum_many(tensors: List[Tensor], group) -> List[Tensor]:
    """:func:`psum` of several tensors in one collective (flattened into
    one buffer of their common dtype, then split back)."""
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), group)
    sizes = [t.numel() for t in tensors]
    return [p.view_as(t) for p, t in zip(flat.split(sizes), tensors)]


def _check_device(t: Tensor, mesh: DeviceMesh) -> None:
    if t.device != local_device(mesh):
        raise ValueError(f"a shard on {t.device} for a rank of a "
                         f"{mesh.device_type} mesh on {local_device(mesh)}; "
                         "place it with shard_batch")


def distributed_edmd_fit(dictionary: Dictionary, data: Snapshots,
                         mesh: DeviceMesh, nlift: Optional[int] = None,
                         method: str = "solve", axis: str = DATA_AXIS
                         ) -> LinearModel:
    """(A, B, C) from the snapshots sharded over the mesh (``data`` is
    this rank's block): the rank's lifts and Grams, one ``all_reduce`` of
    the four Grams and the count, then :func:`edmd.batch.fit_from_grams`
    by ``method`` on every rank (the (d, d) solve, d = nlift + m, is
    cheaper replicated than split)."""
    _check_device(data.x, mesh)
    nlift = dictionary.nlift if nlift is None else nlift
    zx, zy = lift_snapshots(dictionary, data)
    local = gram_stats(zx, zy, data.u, data.x)
    total = GramStats(*psum_many(list(local), mesh.get_group(axis)))
    return fit_from_grams(total, nlift, method=method)


def sharded_closed_loop(closed_loop, mesh: DeviceMesh, params, x0: Tensor,
                        model0: LinearModel, rls0, theta0=None, theta1=None,
                        axis: str = DATA_AXIS):
    """The batched closed loop on this rank's scenarios: every argument is
    the rank's block (:func:`.mesh.shard_batch`). Returns the rank's
    (final carries, logs) with the leading scenario axis in
    ``shard_batch``'s order; rank r's rows are the global batch's
    ``[r B/W, (r+1) B/W)``."""
    _check_device(x0, mesh)
    return run_batch(closed_loop, params, x0, model0, rls0, theta0, theta1)


def psum_mean(values: Tensor, mesh: DeviceMesh, axis: str = DATA_AXIS
              ) -> Tensor:
    """The global mean over the leading axis of values sharded over the
    mesh: the ranks' sums and counts, each summed over the group."""
    _check_device(values, mesh)
    local_sum = values.sum(0)
    count = torch.full((1,), values.shape[0], dtype=values.dtype,
                       device=values.device)
    total, n = psum_many([local_sum, count], mesh.get_group(axis))
    return total / n[0]
