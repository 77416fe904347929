"""Fused condensed-QP solve, scenario-in-lanes (SoA) layout.

Replaces the TPU kernel ``koopmanx/ops/qp_pallas_soa.py::fused_qp_solve_soa``
(body ``_kernel`` :64-186) with ``koopmanx_torch/csrc/fused_qp_soa.cu``:
lane l of every warp of a block works on scenario ``32 * block + l``, the
block's warps split the rows of every product, and the working set lives
in shared memory laid out [element][32 lanes] and in registers (see the
note at the top of the source). Shapes too large for that instance run a
second one, one thread per scenario with a global scratch;
:func:`~koopmanx_torch.ops.fused_qp.soa_instance` picks it from the shapes.
It computes the same function as the AoS kernel, whose plain version
:func:`~koopmanx_torch.ops.fused_qp.fused_qp_reference` is this entry
point's too.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from .fused_qp import (
    FusedQPConfig,
    KernelLib,
    check_inputs,
    check_soa_limits,
    fused_qp_reference,
    soa_instance,
    soa_scratch_rows,
)

_SOA = KernelLib("fused_qp_soa", n_ptrs=8)


def fused_qp_solve_soa(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor,
                       yr: Tensor, warm: Tensor,
                       cfg: FusedQPConfig = FusedQPConfig()) -> Tensor:
    """The signature and result of
    :func:`~koopmanx_torch.ops.fused_qp.fused_qp_solve`: (B, N*m).

    On CPU tensors this is the plain version. On CUDA tensors it launches
    one kernel on the current stream, which reads the (B, ...) inputs as
    they are and writes u; only the global instance gets a scratch. It
    raises where ``fused_qp_solve`` does and on sizes beyond
    :func:`~koopmanx_torch.ops.fused_qp.check_soa_limits`; it never falls
    back."""
    if a.device.type == "cpu":
        return fused_qp_reference(a, b, cyc, z0, yr, warm, cfg)
    if a.device.type != "cuda":
        raise ValueError(f"fused_qp_solve_soa runs on CPU or CUDA, got "
                         f"{a.device}")
    bsz, nz, m, py = check_inputs(a, b, cyc, z0, yr, warm, cfg)
    check_soa_limits(nz, m, py, cfg, a.dtype)
    u = torch.empty_like(warm)
    scratch = None
    if soa_instance(nz, m, py, cfg, a.dtype) == "global":
        scratch = torch.empty((soa_scratch_rows(nz, m, py, cfg.horizon), bsz),
                              dtype=a.dtype, device=a.device)
    ptrs = [t.data_ptr() for t in (a, b, cyc, z0, yr, warm, u)]
    _SOA.launch(ptrs + [None if scratch is None else scratch.data_ptr()],
                [bsz, nz, m, py, cfg.horizon], cfg, a.dtype, a.device)
    fused_qp_solve_soa.launches += 1
    return u


fused_qp_solve_soa.launches = 0


class SoALaunchShape(NamedTuple):
    instance: str  # "shared" or "global"
    nxp: int  # N*m rounded up to 4 (shared instance), else 0
    registers: int  # per thread, as ptxas allotted them
    shared_bytes: int  # dynamic shared memory per block
    warps_per_block: int
    resident_warps_per_sm: int
    waves: int  # rounds of resident blocks that cover the batch


def launch_shape(dtype: torch.dtype, batch: int, nz: int, m: int, py: int,
                 cfg: FusedQPConfig) -> SoALaunchShape:
    """How :func:`fused_qp_solve_soa` launches the kernel at a shape on the
    current CUDA device (the kernel's own occupancy query; no launch)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused QP takes float32 or float64, got {dtype}")
    instance = soa_instance(nz, m, py, cfg, dtype)
    lib = _SOA.load()
    fn = lib.fused_qp_soa_launch_shape
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(int(dtype == torch.float64), int(instance == "global"), batch,
             nz, m, py, cfg.horizon, ctypes.addressof(out))
    if err != 0:
        msg = lib.fused_qp_soa_error_string(err).decode()
        raise RuntimeError(f"fused_qp_soa launch shape failed: {msg} ({err})")
    regs, smem, warps, resident, waves, nxp = out
    return SoALaunchShape(instance, nxp, regs, smem, warps, resident, waves)
