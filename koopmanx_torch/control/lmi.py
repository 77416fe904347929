"""LMI terminal-cost synthesis, the Revise_2 SDP (counterpart of
``koopmanx/control/lmi.py``).

The reference re-certifies stability every control step by solving, with
YALMIP (``Revise_2/Koopman_update.m:314-357``):

  find   gamma, X1 (m x m), Q1 (N x N), Y1 (m x N)
  s.t.   LMI0 = [X1 Y1; Y1' Q1]                      >= 0
         LMI1 = [1 psi'; psi Q1]                     >= 0.01 I
         LMI2 = [Q1          (A Q1 + B Y1)'  (sqrtQ Q1)'  (sqrtR Y1)';
                 A Q1+B Y1    Q1              0            0;
                 sqrtQ Q1     0               gamma I      0;
                 sqrtR Y1     0               0            gamma I ]  >= 0
         Q1 >= 0,  X1(j,j) <= u_max^2
  min    gamma

and recovers K = Y1 inv(Q1), P = gamma inv(Q1) (``:361-381``). The three
bodies of the JAX package are here, each batched over a leading scenario
axis where the JAX package was ``vmap``-ed (models (B, N, N) etc., ``psi``
(B, N), ``u_max`` a number or (B,)); its ``lax.scan`` loops are Python
loops:

- ``method='auto'`` (the engine's): the R-detuned DARE family
  (:func:`_solve_detuned_dare`). The DARE point s = 1 and the 12 grid
  points s = 2^1 .. 2^12 are independent, so they run as ONE doubling
  DARE over (13 B) problems; the 12 geometric-bisection points then run
  one after another, as selects per scenario. ``polish_iters`` > 0 adds
  the log-det barrier Newton polish (:func:`_gamma_polish`, an exact
  Hessian by ``torch.func.hessian`` under ``vmap``);
- ``method='penalized'``: Adam on ``gamma + penalty * sum relu(margin -
  eig)^2``, written out as ``optax.adam`` computes it (b1 0.9, b2 0.999,
  eps 1e-8, eps_root 0, bias-corrected) on one batched set of variables,
  then the Lyapunov correction.

``torch.linalg.eigvalsh`` of a matrix with a non-finite entry does not
give NaN as JAX's does (on the CPU it may return finite values or raise);
:func:`_eigvalsh` feeds such a matrix an identity and returns NaN for it,
so every eigenvalue function here is NaN exactly where JAX's is.

The port's :class:`LMIResult` also carries ``branch`` (``method='auto'``:
0 the DARE point, 1 the detuned pair, 2 the most-detuned fallback, per
scenario; None otherwise), which the JAX package computes but does not
return.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.func import grad, hessian, vmap

from ..ops.linalg import gj_solve, spd_inverse
from ..types import LinearModel
from .dare import dlqr_gain, solve_dare_doubling, solve_dlyap_doubling


class LMIResult(NamedTuple):
    p: Tensor  # terminal cost P = gamma inv(Q1)
    k: Tensor  # terminal gain K = Y1 inv(Q1), u = K z
    gamma: Tensor
    q1: Tensor
    feasibility: Tensor  # max PSD violation across the LMIs (<= 0 feasible)
    branch: Optional[Tensor] = None  # 'auto': 0 DARE, 1 detuned, 2 fallback


class _Vars(NamedTuple):
    gamma_raw: Tensor  # gamma = softplus(gamma_raw)
    x1: Tensor
    q1_raw: Tensor  # Q1 = sym(q1_raw)
    y1: Tensor


BRANCH_NAMES = ("dare", "detuned", "fallback")


def _t(x: Tensor) -> Tensor:
    return x.transpose(-1, -2)


def _sym(m: Tensor) -> Tensor:
    return 0.5 * (m + _t(m))


def _diag(m: Tensor) -> Tensor:
    return m.diagonal(dim1=-2, dim2=-1)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _quad(v: Tensor, p: Tensor) -> Tensor:
    """v' P v, as (v @ P) @ v."""
    return ((v.unsqueeze(-2) @ p).squeeze(-2) * v).sum(-1)


def _eigvalsh(m: Tensor) -> Tensor:
    """Eigenvalues of sym(m), NaN for a matrix with a non-finite entry (as
    ``jnp.linalg.eigvalsh``), which the decomposition never sees."""
    s = _sym(m)
    finite = torch.isfinite(s).all(-1).all(-1)
    w = torch.linalg.eigvalsh(torch.where(finite[..., None, None], s,
                                          _eye(s.shape[-1], s)))
    return torch.where(finite[..., None], w, float("nan"))


def _eig_penalty(m: Tensor, margin: float = 0.0) -> Tensor:
    """sum relu(margin - lambda_i)^2, zero iff M >= margin I."""
    return (F.relu(margin - _eigvalsh(m)) ** 2).sum(-1)


def _min_eig(m: Tensor) -> Tensor:
    return _eigvalsh(m).amin(-1)


def _block(rows, batch) -> Tensor:
    """A block matrix from rows of blocks, each block broadcast to the
    leading dims ``batch``."""
    return torch.cat([torch.cat([blk.expand(batch + blk.shape[-2:])
                                 for blk in row], dim=-1) for row in rows],
                     dim=-2)


def _lmi_blocks(gamma: Tensor, x1: Tensor, q1: Tensor, y1: Tensor, a: Tensor,
                b: Tensor, sqrt_q: Tensor, sqrt_r: Tensor, psi: Tensor):
    """LMI0, LMI1 and LMI2 of the reference's set (``lmi.py:87-104``);
    leading dims broadcast."""
    nlift, m = a.shape[-1], b.shape[-1]
    batch = torch.broadcast_shapes(gamma.shape, x1.shape[:-2], q1.shape[:-2],
                                   a.shape[:-2], psi.shape[:-1])
    z = lambda r, c: torch.zeros((r, c), dtype=q1.dtype, device=q1.device)
    lmi0 = _block([[x1, y1], [_t(y1), q1]], batch)
    one = torch.ones((1, 1), dtype=q1.dtype, device=q1.device)
    lmi1 = _block([[one, psi.unsqueeze(-2)], [psi.unsqueeze(-1), q1]], batch)
    aq_by = a @ q1 + b @ y1
    sq_q1 = sqrt_q @ q1
    sr_y1 = sqrt_r @ y1
    g = gamma[..., None, None]
    lmi2 = _block([
        [q1, _t(aq_by), _t(sq_q1), _t(sr_y1)],
        [aq_by, q1, z(nlift, nlift), z(nlift, m)],
        [sq_q1, z(nlift, nlift), g * _eye(nlift, q1), z(nlift, m)],
        [sr_y1, z(m, nlift), z(m, nlift), g * _eye(m, q1)],
    ], batch)
    return lmi0, lmi1, lmi2


def _build_lmis(v: _Vars, a, b, sqrt_q, sqrt_r, psi, u2):
    """The penalized program's LMIs at its raw variables
    (``lmi.py:77-110``); ``u2`` is u_max^2."""
    gamma = torch.logaddexp(v.gamma_raw, torch.zeros_like(v.gamma_raw))
    q1, x1, y1 = _sym(v.q1_raw), _sym(v.x1), v.y1
    lmi0, lmi1, lmi2 = _lmi_blocks(gamma, x1, q1, y1, a, b, sqrt_q, sqrt_r,
                                   psi)
    input_slack = u2[..., None] - _diag(x1)  # >= 0 required
    return gamma, q1, x1, y1, lmi0, lmi1, lmi2, input_slack


def _lmi_feasibility(a: Tensor, b: Tensor, sqrt_q: Tensor, sqrt_r: Tensor,
                     psi: Tensor, u2: Tensor, gamma: Tensor, p: Tensor,
                     k: Tensor) -> Tensor:
    """Max violation of the REFERENCE's LMI set at a candidate
    (gamma, P, K) (``lmi.py:113-156``; the twin of
    ``eval/sdp_oracle.py::check_reference_lmis``): Q1 = gamma P^-1,
    Y1 = K Q1, the Schur-minimal X1 = gamma K P^-1 K'. <= 0 means
    certified feasible. ``u2`` is u_max^2."""
    p_inv = spd_inverse(p, eps=1e-9)
    g = gamma[..., None, None]
    q1 = _sym(g * p_inv)
    y1 = k @ q1
    x1 = _sym(g * (k @ (p_inv @ _t(k))))
    lmi0, lmi1, lmi2 = _lmi_blocks(gamma, x1, q1, y1, a, b, sqrt_q, sqrt_r,
                                   psi)
    return torch.maximum(
        torch.maximum(-_min_eig(lmi0), -_min_eig(lmi1)),
        torch.maximum(-_min_eig(lmi2),
                      F.relu(_diag(x1) - u2[..., None]).amax(-1)))


def _problem(model: LinearModel, q_lift: Tensor, r, psi: Tensor, u_max):
    """The batched data of one call: A, B, Q (a matrix; a vector is its
    diagonal), R (at least 2-D), the diagonal sqrt(Q) (elementwise on
    the diagonal, the reference's sqrtm of a diagonal Q_lift), the
    elementwise sqrt(R), psi and u_max^2, each with the batch dims."""
    a, b = model.A, model.B
    batch, nlift, m = a.shape[:-2], a.shape[-1], b.shape[-1]
    dtype, dev = a.dtype, a.device
    r_mat = torch.as_tensor(r, dtype=dtype, device=dev)
    while r_mat.dim() < 2:
        r_mat = r_mat.unsqueeze(-1)
    q_mat = torch.as_tensor(q_lift, dtype=dtype, device=dev)
    if q_mat.dim() == 1:
        q_mat = torch.diag_embed(q_mat)
    q_mat = q_mat.expand(batch + (nlift, nlift))
    r_mat = r_mat.expand(batch + (m, m))
    sqrt_q = torch.where(torch.eye(nlift, dtype=torch.bool, device=dev),
                         torch.sqrt(torch.clamp(q_mat, min=0.0)), 0.0)
    u2 = torch.as_tensor(u_max, dtype=dtype, device=dev) ** 2
    return (a, b, q_mat, r_mat, sqrt_q, torch.sqrt(r_mat),
            psi.expand(batch + (nlift,)), u2.expand(batch))


def solve_terminal_lmi(model: LinearModel, q_lift: Tensor, r, psi: Tensor,
                       u_max=2.0, iters: int = 300, lr: float = 5e-2,
                       penalty: float = 1e3, margin: float = 1e-2,
                       lyapunov_correct: bool = True, method: str = "auto",
                       detune_grid: int = 12, detune_bisect: int = 12,
                       polish_iters: int = 0) -> LMIResult:
    """Solve the Revise_2 terminal LMI for each scenario's model
    (``lmi.py:159-309``): ``psi`` (B, N) is the lifted tracking error
    liftFun(x - r) (``Revise_2/Koopman_update.m:331``). An unbatched model
    (A of shape (N, N)) is one scenario, returned without the axis.

    ``method='auto'``: the exact optimum (P_dare, K_dare, psi' P_dare psi)
    where the input bound is slack at the DARE point; else the first
    certifying member of the R-detuned DARE family dare(A, B, Q, s R) on
    the grid s = 2^1 .. 2^detune_grid, bisected ``detune_bisect`` times;
    else the most detuned member (its violation shows in
    ``feasibility``). ``polish_iters`` > 0 then runs the barrier polish
    on the binding case and keeps a certified improvement.
    ``method='penalized'`` (any method but 'auto'): ``iters`` Adam steps
    from the DARE pair, then (``lyapunov_correct``) P from the solved
    gain's Lyapunov equation."""
    if model.A.dim() == 2:
        res = solve_terminal_lmi(
            LinearModel(*(t.unsqueeze(0) for t in model)), q_lift, r,
            psi.unsqueeze(0), u_max, iters, lr, penalty, margin,
            lyapunov_correct, method, detune_grid, detune_bisect,
            polish_iters)
        return LMIResult(*(None if t is None else t[0] for t in res))
    data = _problem(model, q_lift, r, psi, u_max)
    if method == "auto":
        return _solve_detuned_dare(data, detune_grid, detune_bisect,
                                   polish_iters)
    # any other method is the penalized program, as in the JAX package
    return _solve_penalized(data, iters, lr, penalty, margin,
                            lyapunov_correct)


def _objective(v: _Vars, a, b, sqrt_q, sqrt_r, psi, u2, margin: float,
               penalty: float) -> Tensor:
    """The penalized program's objective, summed over the scenarios
    (``lmi.py:246-259``): they do not mix, so the gradient of the sum is
    each one's own."""
    gamma, q1, x1, y1, lmi0, lmi1, lmi2, slack = _build_lmis(
        v, a, b, sqrt_q, sqrt_r, psi, u2)
    pen = (_eig_penalty(lmi0) + _eig_penalty(lmi1, margin)
           + _eig_penalty(lmi2) + _eig_penalty(q1, 1e-6)
           + (F.relu(-slack) ** 2).sum(-1))
    return (gamma + penalty * pen).sum()


def _solve_penalized(data, iters: int, lr: float, penalty: float,
                     margin: float, lyapunov_correct: bool) -> LMIResult:
    """``method='penalized'`` (``lmi.py:214-309``)."""
    a, b, q_mat, r_mat, sqrt_q, sqrt_r, psi, u2 = data
    # DARE warm start: P satisfies the decrease LMI with equality
    p0 = solve_dare_doubling(a, b, q_mat, r_mat)
    k0 = -dlqr_gain(a, b, q_mat, r_mat, p0)  # u = K z convention (ref :361)
    gamma0 = torch.clamp(_quad(psi, p0), min=1.0) * 2.0
    q1_0 = gamma0[..., None, None] * spd_inverse(p0, eps=1e-6)
    y1_0 = k0 @ q1_0
    x1_0 = torch.diag_embed(torch.minimum(
        _diag(y1_0 @ (spd_inverse(q1_0) @ _t(y1_0))) * 1.5 + 1e-3,
        u2[..., None] * 0.9))
    # stable softplus^-1: y + log(1 - exp(-y))
    g0 = torch.clamp(gamma0, min=1e-3)
    v = _Vars(gamma_raw=g0 + torch.log1p(-torch.exp(-g0)), x1=x1_0,
              q1_raw=q1_0, y1=y1_0)

    # optax.adam(lr) written out: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    # bias-corrected; autograd on copies (callable in inference mode)
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.inference_mode(False), torch.enable_grad():
        v = _Vars(*(t.clone() for t in v))
        consts = tuple(t.clone() for t in (a, b, sqrt_q, sqrt_r, psi, u2))
        grad_fn = grad(lambda vv: _objective(vv, *consts, margin, penalty))
        mu = [torch.zeros_like(t) for t in v]
        nu = [torch.zeros_like(t) for t in v]
        for count in range(1, iters + 1):
            g = grad_fn(v)
            mu = [(1 - b1) * gi + b1 * mi for gi, mi in zip(g, mu)]
            nu = [(1 - b2) * (gi * gi) + b2 * ni for gi, ni in zip(g, nu)]
            c1, c2 = 1 - b1 ** count, 1 - b2 ** count
            v = _Vars(*(vi + (-lr) * ((mi / c1) / (torch.sqrt(ni / c2) + eps))
                        for vi, mi, ni in zip(v, mu, nu)))

    gamma, q1, x1, y1, lmi0, lmi1, lmi2, slack = _build_lmis(
        v, a, b, sqrt_q, sqrt_r, psi, u2)
    feas = torch.maximum(
        torch.maximum(-_min_eig(lmi0), -_min_eig(lmi2)),
        torch.maximum(margin - _min_eig(lmi1), F.relu(-slack).amax(-1)))
    q1_inv = spd_inverse(q1, eps=1e-9)
    k_out = y1 @ q1_inv
    p_out = gamma[..., None, None] * q1_inv
    if lyapunov_correct:
        acl = a + b @ k_out
        q_cl = q_mat + _t(k_out) @ r_mat @ k_out
        p_out = solve_dlyap_doubling(acl, q_cl)
        gamma = torch.maximum(gamma, _quad(psi, p_out) * 1.001)
        # the Schur-minimal X1 of the RETURNED pair must still certify the
        # input bound (Revise_2/Koopman_update.m:350-353)
        x1_min_diag = gamma[..., None] * _diag(
            k_out @ (spd_inverse(p_out, eps=1e-9) @ _t(k_out)))
        feas = torch.maximum(
            feas, F.relu(x1_min_diag - u2[..., None]).amax(-1))
    return LMIResult(p=p_out, k=k_out, gamma=gamma, q1=q1, feasibility=feas)


def _sym_index(n: int, offset: int, device) -> Tensor:
    """(n, n) positions in the packed vector of a symmetric matrix stored
    by its upper triangle, row by row (``jnp.triu_indices``), from
    ``offset``: entry (i, j) reads the packed (min, max) pair."""
    iu = torch.triu_indices(n, n)
    pos = torch.empty((n, n), dtype=torch.long)
    k = torch.arange(iu.shape[1]) + offset
    pos[iu[0], iu[1]] = k
    pos[iu[1], iu[0]] = k
    return pos.to(device)


def _gamma_polish(data, q1_0: Tensor, y1_0: Tensor, gamma_0: Tensor,
                  iters: int, mu: float = 5.0, newton_per_stage: int = 12):
    """Gamma descent on the binding case (``lmi.py:312-470``): a log-det
    barrier Newton solve of the full SDP over (gamma, X1, Q1, Y1) packed
    in one vector, seeded at the first strictly interior member of the
    ridged detuned grid (``q1_0``, ``y1_0``, ``gamma_0`` carry the grid
    axis first), ``iters`` stages of ``newton_per_stage`` damped Newton
    steps with t growing by ``mu``, each step's 14-candidate backtracking
    selected per scenario on strict feasibility and Armijo decrease. The
    gradient and the exact Hessian come from ``torch.func`` under
    ``vmap`` over the scenarios. Returns (P, K, gamma, ok); ``ok`` False
    keeps the family's result."""
    a, b, q_mat, r_mat, sqrt_q, sqrt_r, psi, u2 = data
    nlift, m = a.shape[-1], b.shape[-1]
    dtype, dev = a.dtype, a.device
    iu_x, iu_q = torch.triu_indices(m, m), torch.triu_indices(nlift, nlift)
    nx_v, nq_v = iu_x.shape[1], iu_q.shape[1]
    pos_x = _sym_index(m, 1, dev)
    pos_q = _sym_index(nlift, 1 + nx_v, dev)
    consts = (a, b, sqrt_q, sqrt_r, psi, u2)

    def unpack(v):
        y1 = v[..., 1 + nx_v + nq_v:].reshape(v.shape[:-1] + (m, nlift))
        return v[..., 0], v[..., pos_x], v[..., pos_q], y1

    def lmis(v, a, b, sqrt_q, sqrt_r, psi, u2):
        gamma, x1, q1, y1 = unpack(v)
        lmi0, lmi1, lmi2 = _lmi_blocks(gamma, x1, q1, y1, a, b, sqrt_q,
                                       sqrt_r, psi)
        # margin-shifted LMI1 (the reference requires LMI1 >= 0.01 I)
        lmi1 = lmi1 - 0.01 * _eye(nlift + 1, lmi1)
        return gamma, lmi0, lmi1, lmi2, q1, u2[..., None] - _diag(x1)

    def barrier(v, t, *c):
        gamma, lmi0, lmi1, lmi2, q1, slack = lmis(v, *c)
        ld = (torch.linalg.slogdet(lmi0)[1] + torch.linalg.slogdet(lmi1)[1]
              + torch.linalg.slogdet(lmi2)[1] + torch.linalg.slogdet(q1)[1]
              + torch.log(torch.clamp(slack, min=1e-300)).sum(-1))
        return t * gamma - ld

    def min_eig_all(v, *c):
        _, lmi0, lmi1, lmi2, q1, slack = lmis(v, *c)
        me = torch.minimum(torch.minimum(_min_eig(lmi0), _min_eig(lmi1)),
                           torch.minimum(_min_eig(lmi2), _min_eig(q1)))
        return torch.minimum(me, slack.amin(-1))

    # strictly feasible seeds from every ridged grid member (gamma x 1.5,
    # the mid-box X1); the first strictly interior one (smallest s)
    gamma_s = gamma_0 * 1.5 + 1e-3
    q1_s = _sym(q1_0 * 1.5)
    y1_s = y1_0 * 1.5
    x1_lo = _sym(y1_s @ (spd_inverse(q1_s, eps=1e-12) @ _t(y1_s)))
    x1_s = 0.5 * (x1_lo + u2[..., None, None] * _eye(m, x1_lo))
    seeds = torch.cat([gamma_s.unsqueeze(-1), x1_s[..., iu_x[0], iu_x[1]],
                       q1_s[..., iu_q[0], iu_q[1]], y1_s.flatten(-2)], dim=-1)
    strict = min_eig_all(seeds, *consts) > 1e-10  # (G, B)
    batch = torch.arange(strict.shape[1], device=dev)
    v = seeds[strict.to(torch.uint8).argmax(0), batch]
    seed_ok = strict.any(0)

    nvar = v.shape[-1]
    nu = (m + nlift) + (nlift + 1) + (3 * nlift + m) + nlift + m
    alphas = 2.0 ** -torch.arange(14, dtype=dtype, device=dev)
    eye_v = _eye(nvar, v)
    with torch.inference_mode(False):
        c = tuple(t.clone() for t in consts)
        grad_f = vmap(grad(barrier))
        hess_f = vmap(hessian(barrier))
        v = v.clone()
        t = torch.clamp(nu / torch.clamp(v[..., 0], min=1.0), min=1.0)
        cand_c = tuple(x.unsqueeze(1) for x in c)
        for _ in range(iters):
            for _ in range(newton_per_stage):
                g, h = grad_f(v, t, *c), hess_f(v, t, *c)
                scale = torch.clamp(h.abs().amax((-1, -2)), min=1.0)
                dx = -gj_solve(h + (1e-12 * scale)[..., None, None] * eye_v,
                               g.unsqueeze(-1))[..., 0]
                lam2 = -(g * dx).sum(-1)
                f0 = barrier(v, t, *c)
                cands = v.unsqueeze(1) + alphas[:, None] * dx.unsqueeze(1)
                feas = min_eig_all(cands, *cand_c) > 0
                fvals = barrier(cands, t[:, None], *cand_c)
                armijo = fvals < f0[:, None] - 1e-4 * alphas * lam2[:, None]
                ok = feas & armijo & torch.isfinite(fvals)
                idx = ok.to(torch.uint8).argmax(-1)  # largest alpha
                v = torch.where(ok.any(-1)[:, None], cands[batch, idx], v)
            t = t * mu

    gamma, x1, q1, y1 = unpack(v)
    # certify the endpoint exactly under the reference LMI set
    feasible = ((min_eig_all(v, *consts) >= 0) & torch.isfinite(gamma)
                & seed_ok)
    q1_inv = spd_inverse(q1, eps=1e-12)
    return (_sym(gamma[..., None, None] * q1_inv), y1 @ q1_inv, gamma,
            feasible)


def _solve_detuned_dare(data, grid: int, bisect: int,
                        polish_iters: int = 0) -> LMIResult:
    """``method='auto'`` (``lmi.py:473-591``); see
    :func:`solve_terminal_lmi`."""
    a, b, q_mat, r_mat, sqrt_q, sqrt_r, psi, u2 = data
    batch, nlift = a.shape[:-2], a.shape[-1]
    dtype, dev = a.dtype, a.device
    # tiny relative lift: the LMI1/LMI2 equalities at the DARE point
    # become strict (round-off headroom for the certificate check); a
    # Python number, rounded to the tensors' dtype as JAX's constant is,
    # and no host-to-device copy
    lift = 1.0 + 1e-6

    def dares(s: Tensor, q: Tensor):
        """P_s and K_s (u = K z) of dare(A, B, Q, s R) for the values
        ``s`` (S, B): one doubling DARE over all S x B problems."""
        lead = s.shape
        flat = lambda x: x.expand(lead + x.shape[-2:]).reshape(
            (-1,) + x.shape[-2:])
        a_f, b_f, q_f = flat(a), flat(b), flat(q)
        r_f = flat(s[..., None, None] * r_mat)
        p = solve_dare_doubling(a_f, b_f, q_f, r_f)
        k = -dlqr_gain(a_f, b_f, q_f, r_f, p)
        return p.reshape(lead + p.shape[-2:]), k.reshape(lead + k.shape[-2:])

    def candidates(s: Tensor):
        """(P_s, K_s, gamma_s, input bound certified) for ``s`` (S, B)."""
        p, k = dares(s, q_mat)
        g = _quad(psi, p) * lift
        x1_diag = g[..., None] * _diag(
            k @ (spd_inverse(p, eps=1e-9) @ _t(k)))
        finite = (torch.isfinite(p).all(-1).all(-1)
                  & torch.isfinite(k).all(-1).all(-1))
        ok = (x1_diag <= u2[..., None]).all(-1) & finite & (g >= 0)
        return p, k, g, ok

    # the DARE point (s = 1) and the geometric grid s = 2^1 .. 2^grid at
    # once: the exact optimum where the input bound is slack, the first
    # certifying detuned member where it binds
    s_grid = 2.0 ** torch.arange(1, grid + 1, dtype=dtype, device=dev)
    s_all = torch.cat([torch.ones(1, dtype=dtype, device=dev), s_grid])
    ps, ks, gs, oks = candidates(s_all[:, None].expand((grid + 1,) + batch))
    p0, k0, g0, ok0 = ps[0], ks[0], gs[0], oks[0]
    ps, ks, gs, oks = ps[1:], ks[1:], gs[1:], oks[1:]
    any_ok = oks.any(0)
    # first certifying s; the largest when none certifies
    idx = torch.where(any_ok, oks.to(torch.uint8).argmax(0), grid - 1)
    rows = torch.arange(idx.numel(), device=dev).reshape(batch)
    s_hi = s_grid[idx]
    p_hi, k_hi, g_hi = ps[idx, rows], ks[idx, rows], gs[idx, rows]

    # geometric bisection on [s_hi / 2, s_hi]: gamma_s grows with s, so
    # shaving s toward the smallest certifying value lowers gamma
    lo, hi = s_hi * 0.5, s_hi
    p_b, k_b, g_b = p_hi, k_hi, g_hi
    for _ in range(bisect):
        mid = torch.sqrt(lo * hi)
        p_m, k_m, g_m, ok = (t[0] for t in candidates(mid[None]))
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
        p_b = torch.where(ok[..., None, None], p_m, p_b)
        k_b = torch.where(ok[..., None, None], k_m, k_b)
        g_b = torch.where(ok, g_m, g_b)

    # the exact optimum where slack at the DARE point; else the bisected
    # detuned pair where one certifies; else the most detuned candidate
    use_det = ~ok0 & any_ok
    pick = lambda x0, xb, xh: torch.where(
        ok0.reshape(ok0.shape + (1,) * (x0.dim() - ok0.dim())), x0,
        torch.where(use_det.reshape(use_det.shape + (1,) * (x0.dim()
                                                            - ok0.dim())),
                    xb, xh))
    p_out, k_out, gamma = pick(p0, p_b, p_hi), pick(k0, k_b, k_hi), pick(
        g0, g_b, g_hi)
    branch = torch.where(ok0, 0, torch.where(use_det, 1, 2))

    if polish_iters > 0:
        # seeds off the family manifold: a RIDGED-Q detuned grid (the
        # unridged members sit on the LMI2 boundary), eps 1e-6 tr Q
        eps_q = 1e-6 * torch.clamp(_diag(q_mat).sum(-1), min=1.0)
        q_ridged = q_mat + eps_q[..., None, None] * _eye(nlift, q_mat)
        p_s, k_s = dares(s_grid[:, None].expand((grid,) + batch), q_ridged)
        g_s = _quad(psi, p_s)
        q1_s = _sym(g_s[..., None, None] * spd_inverse(p_s, eps=1e-12))
        p_p, k_p, g_p, ok_p = _gamma_polish(data, q1_s, k_s @ q1_s, g_s,
                                            polish_iters)
        # a certified IMPROVEMENT only, never on the slack fast path
        take = ~ok0 & ok_p & (g_p < gamma)
        p_out = torch.where(take[..., None, None], p_p, p_out)
        k_out = torch.where(take[..., None, None], k_p, k_out)
        gamma = torch.where(take, g_p, gamma)

    feas = _lmi_feasibility(a, b, sqrt_q, sqrt_r, psi, u2, gamma, p_out,
                            k_out)
    q1 = _sym(gamma[..., None, None] * spd_inverse(p_out, eps=1e-9))
    return LMIResult(p=p_out, k=k_out, gamma=gamma, q1=q1, feasibility=feas,
                     branch=branch)
