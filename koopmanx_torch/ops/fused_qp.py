"""Fused condensed-QP solve: the AoS CUDA kernel and the plain version.

Replaces the TPU kernel ``koopmanx/ops/qp_pallas.py::fused_qp_solve``
(body ``_kernel`` :55-211) with ``koopmanx_torch/csrc/fused_qp.cu``, one
warp per scenario. For N*m <= 32 its register instance runs the
Newton-Schulz products as 4 x 4 register tiles (K', X, X' and T in the
warp's shared memory) and keeps each lane's row of the KKT inverse in
registers for the ADMM; wider shapes run the first design, the working set
in shared memory (:func:`aos_instance` picks one from the shapes; see the
note at the top of the source for the bound and the design).
``ops/fused_qp_soa.py`` holds the scenario-in-lanes counterpart of
``qp_pallas_soa.py``. Both kernels compute one function, whose plain
PyTorch version is :func:`fused_qp_reference`.

The function: the whole box-constrained output-tracking MPC QP of one
control step, built and solved per scenario in one launch:

1. Markov blocks ``M_j = clip(CyC A^j B)`` and F1 z0 rows
   ``clip(CyC A^(j+1) z0)``, j < N, each clipped to +-f_clamp;
2. F2, the block lower-triangular Toeplitz matrix of the ``M_j``;
   ``P = 2(F2' Qbar F2 + Rbar)``, not symmetrized;
   ``q = 2 F2' Qbar (F1 z0 - yr)``;
3. ``rho = rho_cfg * max(trace(P)/nx, 1e-6)``, ``K = P + (sigma + rho) I``;
4. ``schulz_iters`` Newton-Schulz steps ``X <- X (2I - K X)`` from
   ``X = K / (|K|_1 |K|_inf)``, converged or not;
5. ``iters`` box-ADMM iterations from ``x = warm``, ``z = clip(warm)``,
   ``y = 0``; the result is the projected iterate z, (B, N*m).

This is the fused kernel's own order of operations, not the engine's
(``control/condensed.py`` with ``engine/core.py``): each Markov block and
F1 z0 row is clipped rather than F1's entries, there is no ``nan_to_num``,
P is not symmetrized, the KKT inverse is Newton-Schulz rather than
Gauss-Jordan, and the ADMM starts from a zero dual.

Weights and bounds (``qdiag``, ``rdiag``, ``u_lo``, ``u_hi``) are
per-channel tuples: entry i of the horizon-stacked vector takes
``vals[i % len(vals)]``, as ``qp_pallas_soa.py::_pattern_col`` does. (The
AoS TPU kernel's ``periodic`` gives the same whenever ``len(qdiag) == py``
and the other three have m entries, as in every configuration of the
repository.)
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from . import build
from .box_admm import box_admm_reference


class FusedQPConfig(NamedTuple):
    """Static configuration (the fields and defaults of
    ``koopmanx/ops/qp_pallas.py::FusedQPConfig``, the flagship's numbers).

    ``tile`` (scenarios per TPU kernel instance) is kept so that a JAX
    config carries over; the CUDA kernels do not read it: the AoS kernel
    gives each scenario one warp (1, 2, 4 or 8 warps a block, whichever
    covers the batch in the fewest waves, for its register instance), the
    SoA kernel 32 scenarios to a block in float32 and 16 in float64 (one
    thread each where the shape is too large for its shared instance), and
    each sizes its blocks itself."""

    horizon: int = 20
    iters: int = 60
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    schulz_iters: int = 16
    f_clamp: float = 1e5
    tile: int = 128
    qdiag: tuple = (100.0, 100.0)  # stage output weights (py,)
    rdiag: tuple = (1e-4,)  # stage input weights (m,)
    u_lo: tuple = (-2.0,)  # input bounds (m,)
    u_hi: tuple = (2.0,)


def _periodic(vals, length: int, like: Tensor) -> Tensor:
    return torch.tensor([float(vals[i % len(vals)]) for i in range(length)],
                        dtype=like.dtype, device=like.device)


def fused_qp_terms(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor,
                   yr: Tensor, cfg: FusedQPConfig) -> Tuple[Tensor, Tensor]:
    """Steps 1-2 of the function: P (B, N*m, N*m) and q (B, N*m)."""
    n_h, clamp = cfg.horizon, cfg.f_clamp
    py, m = cyc.shape[-2], b.shape[-1]
    g, s = cyc, z0.unsqueeze(-1)  # CyC A^j, A^j z0
    markov, f1z = [], []
    for _ in range(n_h):
        markov.append(torch.clamp(g @ b, -clamp, clamp))  # (B, py, m)
        g = g @ a
        s = a @ s
        f1z.append(torch.clamp(cyc @ s, -clamp, clamp))  # (B, py, 1)
    f1z = torch.cat(f1z, dim=1).squeeze(-1)  # (B, N*py)
    zero = torch.zeros_like(markov[0])
    f2 = torch.cat([
        torch.cat([markov[i - j] if i >= j else zero for j in range(n_h)], dim=2)
        for i in range(n_h)
    ], dim=1)  # (B, N*py, N*m): F2[i, j] = M_{i-j}
    f2t = f2.transpose(-1, -2)
    qbar = _periodic(cfg.qdiag, n_h * py, a)
    rbar = _periodic(cfg.rdiag, n_h * m, a)
    p_mat = 2.0 * (f2t @ (f2 * qbar[:, None]) + torch.diag(rbar))
    err = (f1z - yr) * qbar
    q_vec = 2.0 * (f2t @ err.unsqueeze(-1)).squeeze(-1)
    return p_mat, q_vec


def newton_schulz_kkt_inverse(p_mat: Tensor, cfg: FusedQPConfig
                              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Steps 3-4: ``(K, X, rho)`` with X the Newton-Schulz inverse of K
    after ``cfg.schulz_iters`` steps."""
    nx = p_mat.shape[-1]
    eye = torch.eye(nx, dtype=p_mat.dtype, device=p_mat.device)
    trace = torch.diagonal(p_mat, dim1=-2, dim2=-1).sum(-1)
    rho = cfg.rho * torch.clamp(trace / nx, min=1e-6)  # (B,)
    kkt = p_mat + (cfg.sigma + rho)[:, None, None] * eye
    norm1 = kkt.abs().sum(-2).amax(-1)
    norminf = kkt.abs().sum(-1).amax(-1)
    x_inv = kkt / (norm1 * norminf)[:, None, None]
    eye2 = 2.0 * eye
    for _ in range(cfg.schulz_iters):
        x_inv = x_inv @ (eye2 - kkt @ x_inv)
    return kkt, x_inv, rho


def fused_qp_reference(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor,
                       yr: Tensor, warm: Tensor,
                       cfg: FusedQPConfig = FusedQPConfig()) -> Tensor:
    """The plain PyTorch version of both fused kernels: (B, N*m)."""
    p_mat, q_vec = fused_qp_terms(a, b, cyc, z0, yr, cfg)
    _, x_inv, rho = newton_schulz_kkt_inverse(p_mat, cfg)
    nx = cfg.horizon * b.shape[-1]
    lo = _periodic(cfg.u_lo, nx, a).expand_as(warm)
    hi = _periodic(cfg.u_hi, nx, a).expand_as(warm)
    out = box_admm_reference(x_inv, q_vec, lo, hi, warm,
                             torch.zeros_like(warm), rho, cfg.iters,
                             cfg.sigma, cfg.alpha)
    return out.z


# ---- the wrappers' checks and the libraries (shared with fused_qp_soa) ----

MAX_CHANNELS = 16  # entries of qdiag/rdiag/u_lo/u_hi the kernels carry
_MAX_NX = 128  # the AoS kernel keeps ceil(N*m / 32) <= 4 ADMM rows per lane
_MAX_REGS_NX = 32  # the widest N*m of the AoS register instance
_MAX_SHARED = 227 * 1024  # shared memory one block may use on Hopper


def _align16(n: int, item: int) -> int:
    """``n`` elements rounded up to a whole number of 16 bytes."""
    per = 16 // item
    return -(-n // per) * per


def aos_shared_bytes(nz: int, m: int, py: int, horizon: int,
                     dtype: torch.dtype, instance: str = "generic") -> int:
    """Shared memory one warp (one scenario) of the AoS kernel holds.

    ``"generic"`` (``Layout`` of ``csrc/fused_qp.cu``, the first design):
    A, B, CyC and two CyC A^j buffers, two state buffers, the Markov blocks
    and the weighted error (the prologue), Qbar, q, rhs, and K, X and two
    Newton-Schulz buffers, N*m x N*m each, back to back.

    ``"regs"`` (``RegsLayout``): K', then X, X' and T (NXP x NXP each, NXP
    = N*m rounded up to 4; the prologue's arrays share their space, which
    is at least the prologue's size), two rhs buffers and q (NXP each),
    Qbar; K', the X-X'-T space, rhs and the whole slice padded to 16
    bytes."""
    item = torch.finfo(dtype).bits // 8
    nx, nrow = horizon * m, horizon * py
    prologue = (nz * nz + nz * m + 3 * py * nz + 2 * nz + horizon * py * m
                + nrow)
    if instance == "generic":
        return item * (prologue + nrow + 2 * nx + 4 * nx * nx)
    if instance != "regs":
        raise ValueError(f"AoS instance is 'regs' or 'generic', got {instance!r}")
    nxp = -(-nx // 4) * 4
    sq = nxp * nxp
    elems = sq + _align16(max(3 * sq, prologue), item) + 3 * nxp + nrow
    return item * _align16(elems, item)


def aos_instance(nz: int, m: int, py: int, cfg: FusedQPConfig,
                 dtype: torch.dtype) -> str:
    """The AoS kernel's instance for a shape: ``"regs"`` (Newton-Schulz
    products as register tiles, the KKT-inverse row in registers) where
    N*m <= 32 and its warp's slice fits 227 KB, else ``"generic"`` (the
    first design). ``csrc/fused_qp.cu::dispatch`` applies the same rule."""
    if (cfg.horizon * m <= _MAX_REGS_NX and aos_shared_bytes(
            nz, m, py, cfg.horizon, dtype, "regs") <= _MAX_SHARED):
        return "regs"
    return "generic"


# the SoA kernel's shared instance: scenarios per block, rows per thread,
# and the widest N*m (rounded up to 4)
_SOA_LANES = {torch.float32: 32, torch.float64: 16}
_SOA_ROWS = 2
_SOA_MAX_NXP = {torch.float32: 24, torch.float64: 20}
_DEFAULT_SHARED = 48 * 1024  # the SoA global instance's per-channel vectors


def soa_shared_bytes(nz: int, m: int, py: int, horizon: int,
                     dtype: torch.dtype) -> int:
    """Shared memory one block of the SoA kernel's shared instance holds
    (``SmemLayout`` of ``csrc/fused_qp_soa.cu``) for its S scenarios (32
    in float32, 16 in float64): X and T (NXP x NXP each, NXP = N*m rounded
    up to 4; the prologue's arrays share T's space where they fit), q, two
    rhs buffers, two norm partials per row group, each element S lanes
    wide; then Qbar."""
    nxp = -(-horizon * m // 4) * 4
    groups = nxp // _SOA_ROWS
    prologue = (nz * nz + nz * m + 3 * py * nz + 2 * nz + horizon * py * m
                + horizon * py)
    lanes = nxp * nxp + max(nxp * nxp, prologue) + 3 * nxp + 2 * groups
    item = torch.finfo(dtype).bits // 8
    return item * (lanes * _SOA_LANES[dtype] + horizon * py)


def soa_instance(nz: int, m: int, py: int, cfg: FusedQPConfig,
                 dtype: torch.dtype) -> str:
    """The SoA kernel's instance for a shape: ``"shared"`` (32 or 16 scenarios
    a block, the working set in shared memory and registers) where N*m fits
    its widest NXP and its block within 227 KB of shared memory, else
    ``"global"`` (one thread per scenario, a global scratch)."""
    nx = cfg.horizon * m
    if (-(-nx // 4) * 4 <= _SOA_MAX_NXP[dtype]
            and soa_shared_bytes(nz, m, py, cfg.horizon, dtype) <= _MAX_SHARED):
        return "shared"
    return "global"


def soa_scratch_rows(nz: int, m: int, py: int, horizon: int) -> int:
    """Rows of the (rows, B) scratch of the SoA global instance
    (``GlobalLayout`` of ``csrc/fused_qp_soa.cu``)."""
    nx, nrow = horizon * m, horizon * py
    return 2 * py * nz + 2 * nz + horizon * py * m + nrow + 5 * nx + 4 * nx * nx


def check_soa_limits(nz: int, m: int, py: int, cfg: FusedQPConfig,
                     dtype: torch.dtype) -> None:
    """The SoA kernel's own limit: its global instance keeps the
    per-channel vectors (N*py weights, N*m bounds twice) in the default
    48 KB of shared memory. The shared instance has none beyond the
    shapes :func:`soa_instance` sends it."""
    if soa_instance(nz, m, py, cfg, dtype) == "shared":
        return
    item = torch.finfo(dtype).bits // 8
    need = cfg.horizon * (py + 2 * m) * item
    if need > _DEFAULT_SHARED:
        raise ValueError(f"fused_qp_solve_soa needs {need} bytes of shared "
                         f"memory for N*(py + 2m) per-channel values, over "
                         f"{_DEFAULT_SHARED}")


def check_inputs(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor, yr: Tensor,
                 warm: Tensor, cfg: FusedQPConfig) -> Tuple[int, int, int, int]:
    """What both kernels take; returns ``(B, nz, m, py)`` or raises."""
    dtype, dev = a.dtype, a.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused QP takes float32 or float64, got {dtype}")
    for name, t in (("a", a), ("b", b), ("cyc", cyc)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be rank 3, got {tuple(t.shape)}")
    bsz, nz, m, py = a.shape[0], a.shape[-1], b.shape[-1], cyc.shape[-2]
    if bsz == 0:
        raise ValueError("fused QP needs at least one scenario")
    n_h = cfg.horizon
    if n_h < 1 or cfg.iters < 0 or cfg.schulz_iters < 0:
        raise ValueError(f"horizon >= 1, iters >= 0, schulz_iters >= 0: {cfg}")
    for field in ("qdiag", "rdiag", "u_lo", "u_hi"):
        if not 1 <= len(getattr(cfg, field)) <= MAX_CHANNELS:
            raise ValueError(f"cfg.{field} must have 1..{MAX_CHANNELS} entries")
    expected = {"a": (bsz, nz, nz), "b": (bsz, nz, m), "cyc": (bsz, py, nz),
                "z0": (bsz, nz), "yr": (bsz, n_h * py), "warm": (bsz, n_h * m)}
    tensors = {"a": a, "b": b, "cyc": cyc, "z0": z0, "yr": yr, "warm": warm}
    for name, t in tensors.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} must be {expected[name]}, got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, a is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return bsz, nz, m, py


def check_aos_limits(nz: int, m: int, py: int, cfg: FusedQPConfig,
                     dtype: torch.dtype) -> None:
    """The AoS kernel's own limits: N*m <= 128 (its ADMM rows live in
    registers, at most four per lane) and one warp's working set in the
    first design's layout within a block's shared memory, which bounds nz,
    N*py and N*m together. (Every shape within them runs: the register
    instance where :func:`aos_instance` picks it, the first design
    elsewhere.)"""
    nx = cfg.horizon * m
    if nx > _MAX_NX:
        raise ValueError(f"fused_qp_solve takes N*m <= {_MAX_NX}, got {nx}")
    need = aos_shared_bytes(nz, m, py, cfg.horizon, dtype)
    if need > _MAX_SHARED:
        raise ValueError(f"fused_qp_solve needs {need} bytes of shared memory "
                         f"per scenario, over the {_MAX_SHARED} a block has")


class KernelLib:
    """One fused-QP library from ``csrc/<name>.cu``, loaded at first use
    (or the already built library at ``path``, which exports the same C
    functions). Each ``<name>_f32``/``_f64`` takes the device pointers
    (``n_ptrs`` of them), the sizes, the scalars, the four per-channel host
    arrays with their lengths, and the stream; it returns a
    ``cudaError_t``."""

    def __init__(self, name: str, n_ptrs: int, path: str = None):
        self.name, self.n_ptrs, self.path = name, n_ptrs, path
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.path
                                      or build.ensure_built(self.name)))
                args = ([ctypes.c_void_p] * self.n_ptrs + [ctypes.c_int] * 7
                        + [ctypes.c_double] * 4
                        + [ctypes.c_void_p, ctypes.c_int] * 4
                        + [ctypes.c_void_p])
                for suffix in ("f32", "f64"):
                    fn = getattr(lib, f"{self.name}_{suffix}")
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                err_fn = getattr(lib, f"{self.name}_error_string")
                err_fn.argtypes = [ctypes.c_int]
                err_fn.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def launch(self, ptrs, sizes, cfg: FusedQPConfig, dtype: torch.dtype,
               device: torch.device) -> None:
        lib = self.load()
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(lib, f"{self.name}_{suffix}")
        chans = [(ctypes.c_double * len(v))(*map(float, v))
                 for v in (cfg.qdiag, cfg.rdiag, cfg.u_lo, cfg.u_hi)]
        chan_args = []
        for arr in chans:  # `chans` keeps the arrays alive through the call
            chan_args += [ctypes.cast(arr, ctypes.c_void_p), len(arr)]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*ptrs, *sizes, cfg.iters, cfg.schulz_iters,
                     float(cfg.rho), float(cfg.sigma), float(cfg.alpha),
                     float(cfg.f_clamp), *chan_args, stream)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: {msg} "
                               f"({err})")


_AOS = KernelLib("fused_qp", n_ptrs=7)


def fused_qp_solve(a: Tensor, b: Tensor, cyc: Tensor, z0: Tensor,
                   yr: Tensor, warm: Tensor,
                   cfg: FusedQPConfig = FusedQPConfig()) -> Tensor:
    """Solve a batch of box-constrained condensed MPC QPs in one launch,
    AoS layout. a (B, nz, nz), b (B, nz, m), cyc = Cy C (B, py, nz),
    z0 (B, nz), yr (B, N*py), warm (B, N*m); returns (B, N*m). Any B.

    On CPU tensors this is :func:`fused_qp_reference`. On CUDA tensors it
    launches the kernel on the current stream (the instance that
    :func:`aos_instance` names for the shapes), or raises on a wrong
    dtype, shape, device or contiguity, on sizes beyond the kernel's
    limits, or on a failed launch; it never falls back."""
    if a.device.type == "cpu":
        return fused_qp_reference(a, b, cyc, z0, yr, warm, cfg)
    if a.device.type != "cuda":
        raise ValueError(f"fused_qp_solve runs on CPU or CUDA, got {a.device}")
    bsz, nz, m, py = check_inputs(a, b, cyc, z0, yr, warm, cfg)
    check_aos_limits(nz, m, py, cfg, a.dtype)
    u = torch.empty_like(warm)
    _AOS.launch([t.data_ptr() for t in (a, b, cyc, z0, yr, warm, u)],
                [bsz, nz, m, py, cfg.horizon], cfg, a.dtype, a.device)
    fused_qp_solve.launches += 1
    return u


fused_qp_solve.launches = 0


class AoSLaunchShape(NamedTuple):
    instance: str  # "regs" or "generic"
    nxp: int  # N*m rounded up to 4 (register instance), else 0
    registers: int  # per thread, as ptxas allotted them
    shared_bytes: int  # dynamic shared memory per block
    warps_per_block: int  # = scenarios per block
    resident_warps_per_sm: int
    waves: int  # rounds of resident blocks that cover the batch


def aos_launch_shape(dtype: torch.dtype, batch: int, nz: int, m: int, py: int,
                     cfg: FusedQPConfig) -> AoSLaunchShape:
    """How :func:`fused_qp_solve` launches the kernel at a shape on the
    current CUDA device (the kernel's own occupancy query; no launch)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused QP takes float32 or float64, got {dtype}")
    instance = aos_instance(nz, m, py, cfg, dtype)
    lib = _AOS.load()
    fn = lib.fused_qp_launch_shape
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(int(dtype == torch.float64), batch, nz, m, py, cfg.horizon,
             ctypes.addressof(out))
    if err != 0:
        msg = lib.fused_qp_error_string(err).decode()
        raise RuntimeError(f"fused_qp launch shape failed: {msg} ({err})")
    regs, smem, warps, resident, waves, nxp = out
    if (nxp > 0) != (instance == "regs"):
        raise RuntimeError(f"fused_qp launches NXP {nxp}, but aos_instance "
                           f"names {instance!r} for this shape")
    return AoSLaunchShape(instance, nxp, regs, smem, warps, resident, waves)
