"""Fused condensed-QP solve, scenario-in-lanes (SoA) layout.

Replaces the TPU kernel ``koopmanx/ops/qp_pallas_soa.py::fused_qp_solve_soa``
(body ``_kernel`` :64-186) with ``koopmanx_torch/csrc/fused_qp_soa.cu``: one
thread per scenario, every input and intermediate laid out (element, B) so
that neighbouring threads touch neighbouring addresses (see the note at
the top of the source). It computes the same function as the AoS kernel,
whose plain version :func:`~koopmanx_torch.ops.fused_qp.fused_qp_reference`
is this entry point's too.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .fused_qp import FusedQPConfig, KernelLib, check_inputs, fused_qp_reference

_SOA = KernelLib("fused_qp_soa", n_ptrs=8)


def fused_qp_solve_soa(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor,
                       yr: Tensor, warm: Tensor,
                       cfg: FusedQPConfig = FusedQPConfig()) -> Tensor:
    """The signature and result of
    :func:`~koopmanx_torch.ops.fused_qp.fused_qp_solve`: (B, N*m).

    On CPU tensors this is the plain version. On CUDA tensors the wrapper
    lays the inputs out scenario-minor, (..., B), as the TPU wrapper did
    (``qp_pallas_soa.py:208-216``; the kernel reads the transposes of A, B
    and CyC from the same arrays, so none is built), launches the kernel
    with a (rows, B) scratch for its working set, and transposes the
    result back. It raises where ``fused_qp_solve`` does; it never falls
    back."""
    if a.device.type == "cpu":
        return fused_qp_reference(a, b, cyc, z0, yr, warm, cfg)
    if a.device.type != "cuda":
        raise ValueError(f"fused_qp_solve_soa runs on CPU or CUDA, got "
                         f"{a.device}")
    bsz, nz, m, py = check_inputs(a, b, cyc, z0, yr, warm, cfg)
    lanes = [t.reshape(bsz, -1).t().contiguous()
             for t in (a, b, cyc, z0, yr, warm)]
    scratch_rows = _SOA.load().fused_qp_soa_scratch_rows
    scratch_rows.argtypes = [ctypes.c_int] * 4
    scratch_rows.restype = ctypes.c_int
    rows = scratch_rows(nz, m, py, cfg.horizon)
    u = torch.empty((cfg.horizon * m, bsz), dtype=a.dtype, device=a.device)
    scratch = torch.empty((rows, bsz), dtype=a.dtype, device=a.device)
    _SOA.launch([t.data_ptr() for t in (*lanes, u, scratch)],
                [bsz, nz, m, py, cfg.horizon], cfg, a.dtype, a.device)
    fused_qp_solve_soa.launches += 1
    return u.t().contiguous()


fused_qp_solve_soa.launches = 0
