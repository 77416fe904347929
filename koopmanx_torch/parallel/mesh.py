"""The scenario mesh and multi-host bring-up (counterpart of
``koopmanx/parallel/mesh.py``).

A 1-D ``('data',)`` mesh over the ranks of a ``torch.distributed``
process group, one card per rank: each scenario's closed loop is
sequential in time, so the scenario batch is the only parallel axis.
Where JAX places a global array's shards with ``device_put``, each rank
here holds its own block of rows (:func:`shard_batch`); the collectives
(``all_reduce`` over the mesh's group: NCCL between cards, gloo between
CPU ranks) are :mod:`.sharded`'s.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve_device
from ..tree import tree_map

DATA_AXIS = "data"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(devices: Optional[Union[str, torch.device]] = None,
              axis: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over every rank of the default process
    group. ``devices`` is the device type of its ranks: ``None`` (the
    card, one a rank: rank r on card r mod the host's count, NCCL) or
    ``'cpu'`` (gloo). Without a card, ``None`` raises, as
    ``device.resolve_device`` does. Where no process group is initialised,
    one of world size 1 is set up on a local store, as JAX builds a mesh
    without ``jax.distributed``; a group the caller initialised (any
    backend) is used as it is."""
    dev = resolve_device(devices)
    if not dist.is_initialized():
        dist.init_process_group(_BACKEND[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def data_sharding(mesh: DeviceMesh, axis: str = DATA_AXIS):
    """The leading (scenario) dimension split over the mesh's one dim."""
    return (Shard(0),)


def replicated(mesh: DeviceMesh):
    return (Replicate(),)


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(tree, mesh: DeviceMesh, axis: str = DATA_AXIS):
    """This rank's block of a scenario-batched tree on its device: rank r
    of W takes rows ``[r B/W, (r+1) B/W)`` of every leaf, the layout of
    JAX's ``P('data')``. B must be divisible by W (pad upstream)."""
    world, rank = mesh.size(), mesh.get_local_rank(axis)
    dev = local_device(mesh)

    def block(t):
        b = t.shape[0]
        if b % world:
            raise ValueError(f"a leading dimension of {b} does not split "
                             f"over {world} ranks; pad it to a multiple")
        n = b // world
        return t[rank * n:(rank + 1) * n].to(dev)

    return tree_map(block, tree)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Multi-host bring-up: the default process group over TCP at
    ``coordinator_address`` (``host:port``, rank 0's). ``backend`` is
    torch's (``None``: NCCL for CUDA tensors and gloo for CPU ones). Does
    nothing single-process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
