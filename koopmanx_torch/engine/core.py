"""The per-step MPC body (counterpart of ``koopmanx/engine/core.py``).

The port has ``make_control_solver`` (:383-729) for the MPC controller:
lifted-space tracking (:416-422); the du formulation (:423-425); the
per-step terminal synthesis with its certificate guard (:429-493), by
the DARE (``terminal_mode='dare'``) or by the Revise_2 LMI
(``terminal_mode='lmi'``, :438-451, ``control/lmi.py``), and
``initial_cert`` (:364-380); the
applied-input window folded into the first decision block's bounds
(``applied_bounds='box'``, :519-584) or as explicit rows
(``applied_bounds='rows'``, :519-539); the state-box rows through F1/F2
(``state_bounds``, :540-556), which send the step to the
general-inequality ADMM (``solve_qp``, :668-676); on the box path the
output-space (low-rank) KKT inverse for py < m on the plain route
(:596-666), or the carried Newton-Schulz KKT inverse (``qp_kkt_refine``,
:612-632) re-anchored exactly every ``qp_kkt_reanchor`` steps, and the
bf16 KKT inverse (``qp_kkt_bf16``, through ``qp_config``); the dither
probe and the du accumulator (:686-704); the
closed-loop LQR controller (``controller='lqr'``, :732-845, no QP and no
kernel); ``dual_dim`` (:854-864); the drift norms (``_matnorm``, :312-315);
every branch of ``make_estimator_update``
(:897-984: ``rls``, ``rls_chol``, ``rls_sqrt``, the windowed Woodbury lane
and refit from the ring buffers, ``storage``) with the model guard
(:988-1008) applied per scenario; and ``change_reset`` (:1015-1047). Every function takes a
leading scenario axis where the JAX package was ``vmap``-ed. The step
index is a Python int, so each ``lax.cond`` on it is a plain branch, or,
for a serving fleet whose episode clocks differ, a ``(B,)`` int64 tensor
of per-plant steps (JAX ``vmap``-ed the index per plant): the reference
windows and the dither are then per plant, and the refit and anchor
schedules per-plant selects, computed only where some plant is due.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import Tensor

from ..control.condensed import (
    augment_delta_u,
    block_diag_repeat,
    condensed_qp,
    prediction_matrices,
    weight_bar,
)
from ..control.qp import (
    ADMMConfig,
    _effective_rho,
    box_kkt,
    make_box_qp_solver,
    solve_qp,
)
from ..control.dare import dlqr_gain, solve_dare_doubling
from ..control.lmi import solve_terminal_lmi
from ..control.terminal import lyapunov_value, synthesize_terminal
from ..edmd.rls import (
    gram_rls_model,
    gram_rls_update,
    rls_update_ab,
    rls_update_c,
    sqrt_rls_model,
    sqrt_rls_update_ab,
    sqrt_rls_update_c,
    storage_model,
    storage_update,
)
from ..edmd.windowed import (
    WindowState,
    window_model,
    window_model_carry,
    window_reanchor,
    window_update,
    window_update_carry,
)
from ..lifts.base import Dictionary
from ..ops.linalg import ns_tracking_inverse, spd_inverse
from ..types import LinearModel, QPSolution, model_from_rls
from .ref import Step


class MPCParams(NamedTuple):
    """Runtime MPC parameters, per scenario (leading batch axis in the
    engine)."""

    q_block: Tensor  # (py, py) stage output weight
    r_block: Tensor  # (m, m) stage input weight
    u_min: Tensor  # (m,) decision bounds (du bounds in du mode)
    u_max: Tensor
    cy: Optional[Tensor] = None  # (py, p) output selector; None = track C z
    applied_min: Optional[Tensor] = None  # (m,) du mode: bounds on u itself
    applied_max: Optional[Tensor] = None
    terminal: Optional[Tensor] = None  # (py, py) static terminal block
    q_lift: Optional[Tensor] = None  # (nlift, nlift) terminal synthesis's Q
    x_min: Optional[Tensor] = None  # (N*py,) stacked state box (Revise_2)
    x_max: Optional[Tensor] = None
    ref_state: Optional[Tensor] = None  # (n,) state-space reference anchor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (field names and defaults of the JAX
    ``EngineConfig``; only fields the port reads or refuses are kept)."""

    horizon: int = 10
    steps: int = 1000
    h: float = 0.05
    integrator: str = "rk4"
    controller: str = "mpc"
    delta_u: bool = False
    applied_bounds: str = "box"  # 'box' folds the applied window into du_0's
    # bounds; 'rows' keeps it as m explicit inequality rows
    track_lifted: bool = False
    update: str = "rls"
    c_pairing: str = "next"  # 'next' (duffing.py:943) | 'same'
    rls_lambda: float = 1.0
    rls_ridge: float = 0.0
    symmetrize: bool = True  # 'rls': re-symmetrize the inverse Grams
    switch_step: int = 100
    markov: str = "dag"
    qp_iters: int = 60
    qp_rho: float = 0.1
    qp_sigma: float = 1e-6
    qp_alpha: float = 1.6
    qp_warm_start: str = "primal"  # 'primal' | 'full' | 'off'
    qp_backend: str = "xla"  # 'pallas' = the CUDA kernel route
    qp_kkt_bf16: bool = False
    qp_kkt_block: int = 4
    qp_kkt_lowrank: bool = True
    qp_kkt_refine: int = 0  # > 0: Newton-Schulz steps of the carried inverse
    qp_kkt_reanchor: int = 16  # its exact re-anchor period
    reset_mult: float = 0.0
    reset_factor: float = 1e-3
    residual_ema: float = 0.98
    # 'windowed' update: Schulz steps of the refit (the spectral filter),
    # the late (shorter) chain from window_filter_warmup on (0: none), the
    # refit cadence past the warm-up; window_carry='woodbury' carries the
    # window's statistics instead, with window_polish Newton-Schulz steps
    # a step and an exact rebuild every window_anchor steps (0: never)
    window_filter: int = 24
    window_filter_late: int = 0
    window_filter_warmup: int = 300
    window_refit_every: int = 1
    window_carry: str = "none"
    window_polish: int = 1
    window_anchor: int = 0
    dither: float = 0.0
    # failure detection: f_clamp saturates prediction-matrix entries;
    # model_guard holds the last sane model when the new one is non-finite
    # or its estimated spectral radius reaches the bound (0 disables)
    f_clamp: float = 1e5
    model_guard: float = 3.0
    terminal_synthesis: bool = False  # per-step terminal synthesis (Revise_2)
    terminal_mode: str = "dare"  # 'dare' | 'lmi' (the Revise_2 LMI)
    state_bounds: bool = False
    drift_norm: str = "fro"  # 'spectral'; any other kind is Frobenius
    # under autograd, recompute each step in the backward pass
    # (torch.utils.checkpoint) instead of keeping its activations: the
    # graph then holds one carry a step. No effect on a run that records
    # no graph.
    remat: bool = False

    @property
    def qp_config(self) -> ADMMConfig:
        return ADMMConfig(
            iters=self.qp_iters,
            rho=self.qp_rho,
            sigma=self.qp_sigma,
            alpha=self.qp_alpha,
            kkt_block=self.qp_kkt_block,
            kkt_bf16=self.qp_kkt_bf16,
        )


UPDATE_MODES = ("rls", "rls_chol", "rls_sqrt", "windowed", "storage", "off")


def check_supported(cfg: EngineConfig) -> None:
    """Refuse unknown option values."""
    if cfg.controller not in ("mpc", "lqr"):
        raise ValueError(f"unknown controller {cfg.controller!r}")
    if cfg.terminal_mode not in ("dare", "lmi"):
        raise ValueError(f"unknown terminal_mode {cfg.terminal_mode!r}")
    if cfg.integrator not in ("rk4", "rk4_matlab"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    if cfg.update not in UPDATE_MODES:
        raise ValueError(f"unknown update {cfg.update!r}")
    if cfg.qp_warm_start not in ("primal", "full", "off"):
        raise ValueError(f"unknown qp_warm_start {cfg.qp_warm_start!r}")
    if cfg.applied_bounds not in ("box", "rows"):
        raise ValueError(f"unknown applied_bounds {cfg.applied_bounds!r}")


def _tree_finite(leaves) -> Tensor:
    """Per scenario: all leaves finite, as isfinite(sum |leaf|) in float32
    (``core.py:292-309``). Leaves carry a leading batch axis; ``None``
    leaves (the refit lane's absent carried statistics) are skipped."""
    total = None
    for leaf in leaves:
        if leaf is None:
            continue
        s = leaf.reshape(leaf.shape[0], -1).to(torch.float32).abs().sum(-1)
        total = s if total is None else total + s
    return torch.isfinite(total)


def _spectral_radius_estimate(a: Tensor, iters: int = 12) -> Tensor:
    """|lambda_max(A)| per scenario by power iteration
    (``core.py:318-338``); NaN propagates."""
    n = a.shape[-1]
    v = torch.full(a.shape[:-1], 1.0 / n ** 0.5, dtype=a.dtype, device=a.device)
    nrm = torch.zeros(a.shape[:-2], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        av = (a @ v.unsqueeze(-1)).squeeze(-1)
        nrm = torch.linalg.vector_norm(av, dim=-1)
        v = av / torch.clamp(nrm, min=1e-30)[..., None]
    return nrm


def _matnorm(d: Tensor, kind: str) -> Tensor:
    """Per scenario: the largest singular value of ``d`` for
    ``kind='spectral'``, else its Frobenius norm (``core.py:312-315``:
    any other kind is Frobenius); NaN for a matrix with a non-finite
    entry, as ``jnp.linalg.norm``, which the SVD never sees."""
    flat = d.flatten(-2)
    if kind != "spectral":
        return torch.linalg.vector_norm(flat, dim=-1)
    finite = torch.isfinite(flat).all(-1)
    norm = torch.linalg.matrix_norm(
        torch.where(finite[..., None, None], d, 0.0), ord=2)
    return torch.where(finite, norm, float("nan"))


def _select(pred: Tensor, new, old):
    """Per-scenario ``where`` over the leaves of two NamedTuples; ``None``
    leaves stay ``None``."""
    out = []
    for a, b in zip(new, old):
        if a is None:
            out.append(None)
            continue
        mask = pred.reshape(pred.shape + (1,) * (a.dim() - 1))
        out.append(torch.where(mask, a, b))
    return type(new)(*out)


def host_to(step: Step, device: torch.device) -> Step:
    """``step`` (per-plant steps or a mask) on ``device``: an int stays an
    int; a host tensor is copied from pinned memory without waiting for
    the device (no host synchronization)."""
    if not isinstance(step, Tensor) or step.device == device:
        return step
    if device.type == "cuda":
        step = step.pin_memory()
    return step.to(device, non_blocking=True)


class ControlDecision(NamedTuple):
    """What :func:`make_control_solver` produces for one step; the fields
    from ``cert`` on feed the carry's certificate and the Revise_2 monitor
    block (``core.py:341-361``), and are ``()`` / None when synthesis is
    off."""

    u_applied: Tensor  # (B, m)
    warm_x: Tensor  # (B, N*m) shifted, sanitized primal warm start
    sol: QPSolution  # sol.y is (B, dual_dim)
    r_window: Tensor  # (horizon, py); (B, horizon, py) for per-plant steps
    cert: Any = ()  # guarded (P, K, gamma), or () when synthesis is off
    cert_ok: Optional[Tensor] = None  # (B,) this step's synthesis passed
    p_lyap: Optional[Tensor] = None  # (B, nlift, nlift) the held P
    cert_k: Optional[Tensor] = None  # (B, m, nlift), u = K z
    cert_gamma: Optional[Tensor] = None  # (B,)
    ref_full: Optional[Tensor] = None  # (B, n) the state-space anchor
    terminal: Optional[Tensor] = None  # (B, py, py) the injected block
    c_for_term: Optional[Tensor] = None  # output map of the injection
    # the carried KKT inverse (B, N*m, N*m) under qp_kkt_refine, before
    # any bf16 rounding; the caller's own () otherwise
    kkt_inv: Any = ()


def initial_cert(cfg: EngineConfig, params: MPCParams, nlift: int, m: int,
                 batch: int, dtype, device) -> Any:
    """The certificate before the first synthesis passes the guard
    (``core.py:364-380``): P = Q_lift (the DARE iterate's start), K = 0,
    gamma = 1, per scenario; ``()`` when synthesis is off."""
    if not cfg.terminal_synthesis:
        return ()
    kw = dict(dtype=dtype, device=device)
    p_seed = (params.q_lift if params.q_lift is not None
              else torch.eye(nlift, **kw))
    return (p_seed.to(dtype).expand(batch, nlift, nlift),
            torch.zeros((batch, m, nlift), **kw),
            torch.ones((batch,), **kw))


def initial_kkt_inv(cfg: EngineConfig, m: int, batch: int, dtype,
                    device) -> Any:
    """The carried KKT inverse's seed (``core.py:867-874``): zeros, never
    read, since step 0 re-anchors; ``()`` when ``qp_kkt_refine`` is 0."""
    if cfg.qp_kkt_refine <= 0:
        return ()
    n_dec = cfg.horizon * m
    return torch.zeros((batch, n_dec, n_dec), dtype=dtype, device=device)


def carried_kkt_inverse(cfg: EngineConfig, kkt: Tensor, kkt_prev: Tensor,
                        step: Step) -> Tensor:
    """The inverse of the box KKT matrices ``kkt`` under ``qp_kkt_refine``
    (``core.py:612-632``): exact (``spd_inverse`` at ``qp_kkt_block``) at
    the steps ``step % qp_kkt_reanchor == 0``, else ``qp_kkt_refine``
    Newton-Schulz steps from last step's ``kkt_prev``. An int step is a
    branch: only one of the two runs, as JAX's ``lax.cond``. Per-plant
    steps (B,), best on the host, are JAX's cond under ``vmap``, a select
    of both per plant: each runs only where some plant takes it."""
    exact = lambda: spd_inverse(kkt, block=cfg.qp_kkt_block)
    tracked = lambda: ns_tracking_inverse(kkt, kkt_prev, cfg.qp_kkt_refine)
    if not isinstance(step, Tensor):
        return exact() if step % cfg.qp_kkt_reanchor == 0 else tracked()
    due = step % cfg.qp_kkt_reanchor == 0
    if bool(due.all()):
        return exact()
    if not bool(due.any()):
        return tracked()
    return torch.where(host_to(due, kkt.device)[:, None, None], exact(),
                       tracked())


def lowrank_kkt_inverse(f2: Tensor, p: Tensor, q_block: Tensor,
                        r_block: Tensor, cfg: EngineConfig) -> Tensor:
    """The inverse of the box KKT matrix ``P + (sigma + rho(P)) I`` in
    output space (``core.py:633-664``), for N*py < N*m. With
    D = 2 Rbar + (sigma + rho) I and Qt = 2 Qbar, both block diagonal,
    KKT = D + F2' Qt F2, so by Woodbury
      KKT^-1 = D^-1 - (F2 D^-1)' S^-1 (F2 D^-1),  S = Qt^-1 + F2 D^-1 F2'
    and only the (N*py, N*py) S is eliminated (at ``qp_kkt_block``); the
    (m, m) and (py, py) blocks at block 1. ``p`` is the QP's symmetrized P,
    from which rho is taken as the box solver takes it. Full float32: the
    entry points pin TF32 off (``device.resolve_device``), as the JAX
    package pins "highest" here. Batched: f2 (B, N*py, N*m), p (B, N*m,
    N*m), blocks (B, k, k)."""
    horizon, m = cfg.horizon, r_block.shape[-1]
    batch, n_out = f2.shape[:-2], f2.shape[-2]
    qp_cfg = cfg.qp_config
    rho = _effective_rho(p, qp_cfg)
    eye = torch.eye(m, dtype=p.dtype, device=p.device)
    d_inv = spd_inverse(2.0 * r_block
                        + (qp_cfg.sigma + rho)[..., None, None] * eye)
    f2d = (f2.reshape(batch + (n_out, horizon, m)) @ d_inv.unsqueeze(-3)
           ).reshape(f2.shape)
    s = (block_diag_repeat(spd_inverse(2.0 * q_block), horizon)
         + f2d @ f2.transpose(-1, -2))
    s_inv = spd_inverse(s, block=cfg.qp_kkt_block)
    f2dt = f2d.transpose(-1, -2)
    kkt_inv = block_diag_repeat(d_inv, horizon) - f2dt @ (s_inv @ f2d)
    return 0.5 * (kkt_inv + kkt_inv.transpose(-1, -2))


def _has_applied_rows(cfg: EngineConfig, params: MPCParams) -> bool:
    return (cfg.delta_u and params.applied_min is not None
            and cfg.applied_bounds == "rows")


def _has_state_rows(cfg: EngineConfig, params: MPCParams) -> bool:
    return cfg.state_bounds and params.x_min is not None


def dual_dim(cfg: EngineConfig, params: MPCParams, m: int) -> int:
    """The QP's constraint rows, the size of the 'full' dual warm start
    (``core.py:854-864``): N*m box rows, m applied-window rows under
    ``applied_bounds='rows'``, N*py state rows under ``state_bounds``."""
    nc = cfg.horizon * m
    if _has_applied_rows(cfg, params):
        nc += m
    if _has_state_rows(cfg, params):
        nc += params.x_min.shape[-1]
    return nc


def make_control_solver(cfg: EngineConfig, ref_fn: Callable[[int], Tensor],
                        m: int, dictionary: Optional[Dictionary] = None):
    """Model -> applied input for a batch of scenarios: the terminal
    synthesis and its certificate guard (``Revise_2/Koopman_update.m:
    331-369``; needs the engine's ``dictionary`` for the anchor), condensed
    QP build (``duffing.py:756-800``, ``Tank_System.m:118-158``), box ADMM
    (or the general-inequality ADMM when rows are added), projection, the
    du accumulator (``Tank_System.m:192``) and the warm shift."""
    check_supported(cfg)
    if cfg.qp_kkt_refine > 0 and cfg.qp_backend == "pallas":
        raise ValueError(
            "qp_kkt_refine (carried KKT inverse) requires qp_backend='xla' "
            "(the Pallas kernel computes its own inverses)"
        )
    if cfg.controller == "lqr":
        return _make_lqr_solver(cfg, ref_fn, m)
    if cfg.terminal_synthesis and dictionary is None:
        raise ValueError("terminal synthesis anchors its certificate at "
                         "psi(x - r): pass the engine's dictionary")
    horizon = cfg.horizon
    qp_cfg = cfg.qp_config
    box_solver = make_box_qp_solver(qp_cfg, backend=cfg.qp_backend)

    def synthesis(params: MPCParams, model: LinearModel, cert, x: Tensor,
                  step: Step):
        """The certificate of each scenario's (online-updated) model, by
        the DARE or, under ``terminal_mode='lmi'``, by the Revise_2 LMI
        anchored at the lifted tracking error psi(x - r) with the
        scenario's first input bound (``Revise_2/Koopman_update.m:331``),
        held per scenario against the previous one where it fails the
        guard: P, K and gamma finite, V at the anchor psi(x - r) >= 0 and
        gamma > 0 (``core.py:429-493``). Returns the held certificate, the
        guard's verdict, the anchor state and the injected terminal block
        with its output map."""
        n = model.C.shape[-2]
        if params.ref_state is not None:
            ref_full = params.ref_state
        else:
            r0 = ref_fn(step)[..., 0, :]
            k = min(r0.shape[-1], n)
            ref_full = torch.zeros(r0.shape[:-1] + (n,), dtype=x.dtype,
                                   device=x.device)
            ref_full[..., :k] = r0[..., :k]
        ref_full = ref_full.expand(x.shape)
        psi = dictionary(x - ref_full)
        if cfg.terminal_mode == "lmi":
            res = solve_terminal_lmi(model, params.q_lift, params.r_block,
                                     psi, u_max=params.u_max[..., 0])
            new = (res.p, res.k, res.gamma)  # u = K z convention (ref :361)
        else:
            tc = synthesize_terminal(model, params.q_lift, params.r_block)
            # dlqr gives u = -K z; the certificate holds the reference's
            # u = K z
            new = (tc.p, -tc.k, tc.gamma)
        v_anchor = lyapunov_value(new[0], psi)
        ok = _tree_finite(new) & (v_anchor >= 0) & (new[2] > 0)
        held = tuple(torch.where(ok.reshape(ok.shape + (1,) * (a.dim() - 1)),
                                 a, b) for a, b in zip(new, cert))
        if cfg.track_lifted:
            # the tracked output is z itself: inject the FULL P
            # (VDP_Revise_2/Koopman_update_Tracking_Lift.m:283)
            c_term = torch.eye(model.A.shape[-1], dtype=x.dtype,
                               device=x.device)
            terminal = held[0]
        else:
            c_term = model.C if params.cy is None else params.cy @ model.C
            terminal = c_term @ held[0] @ c_term.transpose(-1, -2)
        return held, ok, ref_full, terminal, c_term

    def control_solve(params: MPCParams, model: LinearModel, z: Tensor,
                      u_prev: Tensor, warm_x: Tensor, warm_y: Any, step: Step,
                      cert: Any = (), x: Optional[Tensor] = None,
                      kkt_prev: Any = ()) -> ControlDecision:
        """``cert`` and the plant state ``x`` are read under terminal
        synthesis only; ``kkt_prev``, last step's KKT inverse, under
        ``qp_kkt_refine`` only: a caller that threads none (``()``, as the
        local-linear loop) gets the exact inverse every step."""
        host_step = step
        step = host_to(step, z.device)
        revise2 = {}
        terminal = params.terminal
        if cfg.terminal_synthesis:
            held, ok, ref_full, terminal, c_term = synthesis(
                params, model, cert, x, step)
            revise2 = dict(cert=held, cert_ok=ok, p_lyap=held[0],
                           cert_k=held[1], cert_gamma=held[2],
                           ref_full=ref_full, terminal=terminal,
                           c_for_term=c_term)
        # lifted-space tracking (vanderpol.py:456-459): the tracked output
        # is z itself, so the predictor's C is the identity
        # (VDP_Revise_2/...m:99: C = eye(Nlift))
        if cfg.track_lifted:
            eye = torch.eye(model.A.shape[-1], dtype=z.dtype, device=z.device)
            model = model._replace(C=eye.expand(model.A.shape))
        # du augmentation of the current (online-updated) model,
        # Tank_System.m:265-268
        if cfg.delta_u:
            model = augment_delta_u(model)
            z_qp = torch.cat([z, u_prev], dim=-1)
        else:
            z_qp = z
        qbar = weight_bar(params.q_block, horizon, terminal)
        rbar = block_diag_repeat(params.r_block, horizon)
        pred = prediction_matrices(model, horizon, params.cy, cfg.markov)
        if cfg.f_clamp > 0.0:
            fc = cfg.f_clamp
            pred = type(pred)(*(
                torch.nan_to_num(f, nan=0.0, posinf=fc, neginf=-fc).clamp(-fc, fc)
                for f in pred
            ))
        r_window = ref_fn(step)  # (horizon, py); py = nlift when lifted
        yr = r_window.flatten(-2)
        # extra inequality rows: the applied window on du_0 ('rows'; one
        # selector [I_m 0] shared by every scenario), the state box on the
        # prediction F1 z + F2 x (F2 per scenario)
        a_rows, l_rows, u_rows = [], [], []
        if _has_applied_rows(cfg, params):
            a_rows.append(torch.eye(m, horizon * m, dtype=z.dtype,
                                    device=z.device))
            l_rows.append(params.applied_min - u_prev)
            u_rows.append(params.applied_max - u_prev)
        if _has_state_rows(cfg, params):
            f1z = (pred.f1 @ z_qp.unsqueeze(-1)).squeeze(-1)
            a_rows.append(pred.f2)
            l_rows.append(params.x_min - f1z)
            u_rows.append(params.x_max - f1z)
        # per-channel bounds (m,) tiled over the horizon
        lo, hi = (v.repeat((1,) * (v.dim() - 1) + (horizon,))
                  for v in (params.u_min, params.u_max))
        if (cfg.delta_u and params.applied_min is not None
                and cfg.applied_bounds == "box"):
            # the applied-input window constrains du_0 alone: intersect it
            # with du_0's box (applied_bounds='box'); the minimum guards an
            # empty intersection. Each scenario gets its own first bounds.
            lo0 = torch.maximum(params.u_min, params.applied_min - u_prev)
            hi0 = torch.minimum(params.u_max, params.applied_max - u_prev)
            lo0 = torch.minimum(lo0, hi0)
            lo = torch.cat([lo0, lo[..., m:]], dim=-1)
            hi = torch.cat([hi0, hi[..., m:]], dim=-1)
        new_kkt = kkt_prev
        if a_rows:
            if cfg.qp_kkt_refine > 0:
                raise ValueError(
                    "qp_kkt_refine > 0 requires the box-only QP fast path; "
                    "this config adds general inequality rows (delta_u "
                    "applied bounds or state_bounds) which use solve_qp's "
                    "own KKT — set qp_kkt_refine=0 for this configuration"
                )
            # the general-inequality ADMM, on every route (the kernel
            # serves the box path only, as in the JAX package); A keeps a
            # batch axis only where a block has one
            batch = torch.broadcast_shapes(*(a.shape[:-2] for a in a_rows))
            a_ineq = torch.cat([a.expand(batch + a.shape[-2:])
                                for a in a_rows], dim=-2)
            qp = condensed_qp(pred, z_qp, yr, qbar, rbar, lo, hi, a_ineq,
                              torch.cat(l_rows, dim=-1),
                              torch.cat(u_rows, dim=-1))
            x0 = warm_x if cfg.qp_warm_start in ("full", "primal") else None
            y0 = warm_y if cfg.qp_warm_start == "full" else None
            sol = solve_qp(qp, qp_cfg, x0=x0, y0=y0)
        else:
            qp = condensed_qp(pred, z_qp, yr, qbar, rbar, lo, hi)
            zeros_x = torch.zeros_like(qp.q)
            x0 = warm_x if cfg.qp_warm_start in ("full", "primal") else zeros_x
            y0 = warm_y if cfg.qp_warm_start == "full" else zeros_x
            n_out = pred.f2.shape[-2]  # N*py
            if cfg.qp_kkt_refine > 0 and not isinstance(kkt_prev, tuple):
                # the carried inverse (plain route only); what is carried
                # is the inverse before the solver's bf16 rounding
                new_kkt = carried_kkt_inverse(cfg, box_kkt(qp.P, qp_cfg),
                                              kkt_prev, host_step)
                sol = box_solver(qp.P, qp.q, qp.l, qp.u, x0, y0, new_kkt)
            elif (cfg.qp_kkt_lowrank and cfg.qp_kkt_refine == 0
                    and cfg.qp_backend == "xla"
                    and terminal is None
                    and n_out < horizon * m):
                kkt_inv = lowrank_kkt_inverse(pred.f2, qp.P, params.q_block,
                                              params.r_block, cfg)
                sol = box_solver(qp.P, qp.q, qp.l, qp.u, x0, y0, kkt_inv)
            else:
                sol = box_solver(qp.P, qp.q, qp.l, qp.u, x0, y0)
        # exact projection of the first move; a non-finite solve applies 0
        first_move = torch.clamp(
            torch.nan_to_num(sol.x[..., :m], nan=0.0, posinf=0.0, neginf=0.0),
            params.u_min, params.u_max,
        )
        if cfg.dither > 0.0:
            first_move = _dithered(cfg, params, first_move, step)
        if cfg.delta_u:
            u_applied = u_prev + first_move  # U0 += dU (Tank_System.m:192)
            if params.applied_min is not None:
                # exact actuator saturation of the accumulator
                u_applied = torch.clamp(u_applied, params.applied_min,
                                        params.applied_max)
        else:
            u_applied = first_move
        # warm start: shift by one move (last move repeated), sanitized
        warm_next = torch.nan_to_num(
            torch.cat([sol.x[..., m:], sol.x[..., -m:]], dim=-1),
            nan=0.0, posinf=0.0, neginf=0.0,
        )
        return ControlDecision(u_applied=u_applied, warm_x=warm_next,
                               sol=sol, r_window=r_window, kkt_inv=new_kkt,
                               **revise2)

    return control_solve


def _dithered(cfg: EngineConfig, params: MPCParams, u: Tensor,
              step: Step) -> Tensor:
    """``u`` plus the deterministic multi-sine probe of persistent
    excitation, clipped to the box; per plant for per-plant steps."""
    if isinstance(step, Tensor):
        t = step.to(u.dtype)[:, None]
    else:
        t = torch.tensor(float(step), dtype=u.dtype, device=u.device)
    probe = cfg.dither * (torch.sin(0.37 * t)
                          + 0.5 * torch.sin(1.13 * t + 1.0))
    return torch.clamp(u + probe, params.u_min, params.u_max)


def _make_lqr_solver(cfg: EngineConfig, ref_fn: Callable[[int], Tensor],
                     m: int):
    """The closed-loop LQR controller (``controller='lqr'``,
    ``core.py:732-845``), the runnable counterpart of the reference's
    dead LQR flag (``duffing.py:682``; gain ``dlqr(A, B, Q, R)`` at
    ``:669``, applied at ``:863-864`` as ``u = -K_gain @ xlift``). Per
    step, on each scenario's current model:

      K = dlqr(A, B, Q_dare, R)          (doubling DARE)
      (z_ss, u_ss) = argmin ||(A - I) z + B u||^2 + ||G z - r||^2
      u = clip(u_ss - K (z - z_ss), u_min, u_max)

    with G the tracked output map (C, or Cy C; the identity under lifted
    tracking, where z_ss is the encoded reference and u_ss the least
    squares of B u = (I - A) z_ss), both through ``spd_inverse`` with a
    1e-8 ridge. Q_dare is ``q_lift`` when given, else the output weight
    pulled back through G, plus 1e-9 tr(Q) I for detectability. A
    non-finite law applies 0; the dither as in the MPC path. No QP and no
    kernel: the solution is zeros shaped as the warm starts, so the loop,
    ``run_batch`` and the serving controllers run it unchanged."""
    if cfg.delta_u or cfg.state_bounds or cfg.terminal_synthesis:
        raise ValueError(
            "controller='lqr' supports the plain tracking formulation only "
            "(no delta_u, state_bounds, or terminal_synthesis — those are "
            "MPC-path features; the reference's LQR flag had none of them)")
    horizon = cfg.horizon

    def control_solve(params: MPCParams, model: LinearModel, z: Tensor,
                      u_prev: Tensor, warm_x: Tensor, warm_y: Any, step: Step,
                      cert: Any = (), x: Optional[Tensor] = None,
                      kkt_prev: Any = ()) -> ControlDecision:
        step = host_to(step, z.device)
        a, b = model.A, model.B
        nlift, batch = a.shape[-1], z.shape[:-1]
        kw = dict(dtype=z.dtype, device=z.device)
        eye_n = torch.eye(nlift, **kw)
        if cfg.track_lifted:
            g = eye_n
        else:
            g = model.C if params.cy is None else params.cy @ model.C
        q_dare = (params.q_lift if params.q_lift is not None
                  else g.transpose(-1, -2) @ params.q_block @ g)
        # the pulled-back Q has rank py: the doubling DARE needs
        # detectability of (A, Q^1/2)
        tr_q = params.q_block.diagonal(dim1=-2, dim2=-1).sum(-1)
        q_dare = q_dare + (1e-9 * tr_q)[..., None, None] * eye_n
        p = solve_dare_doubling(a, b, q_dare, params.r_block)
        k = dlqr_gain(a, b, q_dare, params.r_block, p)  # u = -K z

        r_window = ref_fn(step)  # (horizon, py), or (B, horizon, py)
        r0 = r_window[..., 0, :].expand(batch + r_window.shape[-1:])
        mv = lambda mat, v: (mat @ v.unsqueeze(-1)).squeeze(-1)
        bt = b.transpose(-1, -2)
        if cfg.track_lifted:
            z_ss = r0
            bb = bt @ b + 1e-8 * torch.eye(m, **kw)
            u_ss = mv(spd_inverse(bb), mv(bt, mv(eye_n - a, z_ss)))
        else:
            g = g.expand(batch + g.shape[-2:])
            mmat = torch.cat([
                torch.cat([a - eye_n, b], dim=-1),
                torch.cat([g, torch.zeros(g.shape[:-1] + (m,), **kw)],
                          dim=-1)], dim=-2)
            rhs = torch.cat([torch.zeros(batch + (nlift,), **kw), r0], -1)
            mt = mmat.transpose(-1, -2)
            mtm = mt @ mmat + 1e-8 * torch.eye(nlift + m, **kw)
            w = mv(spd_inverse(mtm), mv(mt, rhs))
            z_ss, u_ss = w[..., :nlift], w[..., nlift:]
        # a transiently non-stabilizable estimate gives NaN (P, K): apply 0
        u_raw = u_ss - mv(k, z - z_ss)
        u_applied = torch.clamp(
            torch.nan_to_num(u_raw, nan=0.0, posinf=0.0, neginf=0.0),
            params.u_min, params.u_max)
        if cfg.dither > 0.0:
            u_applied = _dithered(cfg, params, u_applied, step)
        zeros_x = torch.zeros(batch + (horizon * m,), **kw)
        sol = QPSolution(
            x=zeros_x, z=zeros_x,
            # warm_y is () unless qp_warm_start='full'
            y=(torch.zeros(batch + (0,), **kw) if isinstance(warm_y, tuple)
               else torch.zeros_like(warm_y)),
            primal_res=torch.zeros(batch, **kw),
            dual_res=torch.zeros(batch, **kw), iterations=0)
        return ControlDecision(u_applied=u_applied,
                               warm_x=torch.zeros_like(warm_x), sol=sol,
                               r_window=r_window, cert=cert, kkt_inv=kkt_prev)

    return control_solve


def make_estimator_update(dictionary: Dictionary, cfg: EngineConfig):
    """One (z, u, z+, c_target) observation per scenario at loop step
    ``step`` -> refreshed estimator and guarded model. Returns
    ``(rls, new_model)``. Per-plant steps come as a (B,) tensor, best on
    the host: the schedules ask it which plants are due without waiting
    for the device."""
    check_supported(cfg)
    nlift = dictionary.nlift
    ridge = max(cfg.rls_ridge, 1e-5)

    def refit(state: WindowState, warm) -> LinearModel:
        late = cfg.window_filter_late > 0 and not warm
        iters = cfg.window_filter_late if late else cfg.window_filter
        return window_model(state, nlift, ridge=ridge, schulz_iters=iters)

    def windowed_refit(state: WindowState, step: int):
        """The refit while ``step < window_filter_warmup``, then every
        ``window_refit_every``-th step; the late chain from the warm-up on
        when ``window_filter_late`` > 0. None where the model is held."""
        warm = step < cfg.window_filter_warmup
        if not (cfg.window_refit_every <= 1 or warm
                or step % cfg.window_refit_every == 0):
            return None
        return refit(state, warm)

    def windowed_refit_per_plant(state: WindowState, model: LinearModel,
                                 step: Tensor) -> Optional[LinearModel]:
        """:func:`windowed_refit` with a (B,) step per plant: each chain
        runs where some plant is due for it, and a plant not due keeps
        ``model``. None where no plant is due."""
        warm = step < cfg.window_filter_warmup
        due = torch.ones_like(warm) if cfg.window_refit_every <= 1 else (
            warm | (step % cfg.window_refit_every == 0))
        if not bool(due.any()):
            return None
        chains = (((True, due & warm), (False, due & ~warm))
                  if cfg.window_filter_late > 0 else ((True, due),))
        new_model = model
        for chain_warm, pick in chains:
            if bool(pick.any()):
                new_model = _select(host_to(pick, model.A.device),
                                    refit(state, chain_warm), new_model)
        return new_model

    def estimator_update(rls, model: LinearModel, z: Tensor, u: Tensor,
                         z_next: Tensor, c_target: Tensor, step: Step):
        if cfg.update == "off":
            return rls, model
        per_plant = isinstance(step, Tensor)
        if cfg.update == "windowed" and cfg.window_carry == "woodbury":
            rls_new = window_update_carry(rls, z, u, z_next, c_target,
                                          polish=cfg.window_polish)
            if cfg.window_anchor > 0:
                due = (step + 1) % cfg.window_anchor == 0
                if per_plant and bool(due.any()):
                    rls_new = _select(host_to(due, z.device),
                                      window_reanchor(rls_new, ridge),
                                      rls_new)
                elif not per_plant and due:
                    rls_new = window_reanchor(rls_new, ridge)
            new_model = window_model_carry(rls_new, nlift)
        elif cfg.update == "windowed":
            # the ring absorbs every observation, refit or not
            rls_new = window_update(rls, z, u, z_next, c_target)
            new_model = (windowed_refit_per_plant(rls_new, model, step)
                         if per_plant else windowed_refit(rls_new, step))
        elif cfg.update == "rls":
            rls_new = rls_update_ab(rls, z, u, z_next, lam=cfg.rls_lambda,
                                    symmetrize=cfg.symmetrize)
            rls_new = rls_update_c(rls_new, z, c_target, lam=cfg.rls_lambda,
                                   symmetrize=cfg.symmetrize)
            new_model = model_from_rls(rls_new, nlift)
        elif cfg.update == "rls_chol":
            rls_new = gram_rls_update(rls, z, u, z_next, c_target,
                                      lam=cfg.rls_lambda)
            new_model = gram_rls_model(rls_new, nlift,
                                       ridge=max(cfg.rls_ridge ** 2, 1e-7))
        elif cfg.update == "storage":
            rls_new = storage_update(rls, z, u, z_next, c_target)
            new_model = storage_model(rls_new, nlift)
        else:
            rls_new = sqrt_rls_update_ab(rls, z, u, z_next,
                                         lam=cfg.rls_lambda,
                                         ridge=cfg.rls_ridge)
            rls_new = sqrt_rls_update_c(rls_new, z, c_target,
                                        lam=cfg.rls_lambda,
                                        ridge=cfg.rls_ridge)
            new_model = sqrt_rls_model(rls_new, nlift)
        if cfg.model_guard > 0.0:
            # a held model is its own guarded fallback: nothing to screen
            if new_model is not None:
                finite = _tree_finite(new_model)
                radius = _spectral_radius_estimate(new_model.A)
                sane = finite & (radius < cfg.model_guard)
                new_model = _select(sane, new_model, model)
            # the estimator never absorbs non-finite carries; out-of-place
            # updates leave ``rls`` intact to fall back on
            rls_new = _select(_tree_finite(rls_new), rls_new, rls)
        return rls_new, model if new_model is None else new_model

    return estimator_update


def change_reset(cfg: EngineConfig, rls, res_ema: Tensor, residual: Tensor):
    """Event-triggered statistic reset on the pre-update one-step residual:
    the statistics of a triggered scenario are scaled by ``reset_factor``
    (the square-root factors by its root). Identity when ``reset_mult`` is
    0 (the flagship preset) or the mode carries no scalable Grams."""
    if not (cfg.reset_mult > 0.0 and cfg.update in ("rls_sqrt", "rls_chol")):
        return rls, res_ema
    warmed = res_ema > 0
    trigger = warmed & (residual > cfg.reset_mult * res_ema)
    one = torch.ones_like(residual)
    alpha = torch.where(trigger, cfg.reset_factor * one, one)
    a2, a3 = alpha[:, None, None], alpha.sqrt()[:, None, None]
    if cfg.update == "rls_sqrt":
        rls = rls._replace(K_A=rls.K_A * a2, r_g=rls.r_g * a3,
                           barX=rls.barX * a2, r_q=rls.r_q * a3)
    else:  # the Gram carry
        rls = rls._replace(K_A=rls.K_A * a2, g=rls.g * a2,
                           barX=rls.barX * a2, q=rls.q * a2)
    ema = cfg.residual_ema * res_ema + (1.0 - cfg.residual_ema) * residual
    res_ema = torch.where(trigger, res_ema, ema)
    res_ema = torch.where(warmed, res_ema, residual)
    return rls, res_ema
