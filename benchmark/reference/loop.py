"""The plain closed loop of a deployment, one control step at a time,
over a batch of scenarios (leading axis B).

What it implements, from the configuration's settings (the
``run_config``, ``plant`` and ``engine`` blocks of its JSON file), with
the plant, the integrator, the lift's dictionary and the estimator found
by name (:mod:`.parts`):

- the training snapshots: u ~ U[u_range] per step, x0 ~ U[x0_range], drawn
  in the configuration's dtype from a CPU generator seeded with the
  configuration's seed (u first, then x0), rolled out under the nominal
  parameters;
- the lift: the dictionary g(x), then g(x) - g(0) (``zero_offset``),
  then [x; g] (``state_augmented``), then (psi - mean) / std over the
  training states (``normalize``; population std, floored at 1e-6);
- the EDMD fit: [A B] = Zy' V pinv(V' V), C = X' Zx pinv(Zx' Zx), with
  V = [Zx U] and pinv's cutoff 10 max(M, N) eps of the configuration's
  dtype;
- the online update: the estimator's observation, then the model guard
  (finite, and 12 power iterations of A from the uniform vector under
  ``model_guard``) and the estimator's finiteness;
- the terminal certificate: P from 30 doubling steps of the DARE with
  Q_lift = diag(q on the n state channels, 0), K = -(R + B'PB)^-1 B'PA
  (u = K z), gamma = trace P, held against the previous one unless P, K
  and gamma are finite, psi(x - r)' P psi(x - r) >= 0 and gamma > 0;
  C P C' is the last block of the stage weight;
- the condensed QP over the horizon N (F1 = [C A^j], F2 = [C A^(i-j) B],
  entries clamped to f_clamp), H = F2' Qbar F2 + Rbar symmetrized,
  P = 2H, q = 2 F2' Qbar (F1 z - r), and the box ADMM: rho = qp_rho
  max(trace P / nx, 1e-6), the inverse of P + (sigma + rho) I, qp_iters
  over-relaxed iterations from the shifted primal warm start and a zero
  dual; the first move, clamped to the box, is applied.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import Tensor

from .parts import part, plant_function


class Prec(NamedTuple):
    """The arithmetic of a reference: its dtype, and whether each matrix
    product first rounds its operands to TF32 (10 mantissa bits, round to
    nearest even), as a TF32 tensor-core product reads them."""

    dtype: torch.dtype
    tf32: bool

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b


F64 = Prec(torch.float64, False)
TF32 = Prec(torch.float32, True)


def tf32_round(t: Tensor) -> Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    rounded = torch.bitwise_and(bits + 0xFFF + lsb, -8192)
    return rounded.view(torch.float32)


Model = Tuple[Tensor, Tensor, Tensor]  # A (B, nz, nz), B (B, nz, m), C (B, n, nz)
Cert = Tuple[Tensor, Tensor, Tensor]  # P (B, nz, nz), K (B, m, nz) for u = K z, gamma (B,)


def _t(a: Tensor) -> Tensor:
    return a.transpose(-1, -2)


def _finite(*leaves: Tensor) -> Tensor:
    """Per scenario: every entry of every leaf finite."""
    ok = None
    for leaf in leaves:
        f = torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(-1)
        ok = f if ok is None else ok & f
    return ok


def _solve(a: Tensor, b: Tensor) -> Tensor:
    """a^-1 b over a batch; NaN where a is singular (the guard then holds
    the previous certificate, as the program's would)."""
    x, info = torch.linalg.solve_ex(a, b)
    return torch.where((info != 0).reshape(info.shape + (1, 1)),
                       torch.full_like(x, float("nan")), x)


def _pick(ok: Tensor, new: Tensor, old: Tensor) -> Tensor:
    return torch.where(ok.reshape(ok.shape + (1,) * (new.dim() - 1)), new, old)


class Reference:
    """One configuration's reference on ``device`` in ``prec``.

    ``config`` is the parsed configuration file; ``root`` the checkout,
    which its weights path is relative to and its parts lie in."""

    def __init__(self, config: dict, root: str, prec: Prec = F64,
                 device: str = "cpu"):
        self.prec = prec
        self.kw = dict(dtype=prec.dtype, device=device)
        rc, eng = config["run_config"], config["engine"]
        self.rc, self.eng = rc, eng
        plant = config["plant"]
        self.n, self.m = plant["n"], plant["m"]
        self.theta0 = plant["theta0"]
        self.theta1 = plant["theta1"]
        self._plant = plant_function(config, root)
        self.switch = rc["switch_step"]
        mpc, upd = rc["mpc"], rc["update"]
        self.horizon = mpc["horizon"]
        self.u_min, self.u_max = float(mpc["u_min"]), float(mpc["u_max"])
        self.q_w, self.r_w = mpc["q_weight"], mpc["r_weight"]
        self.synthesis = mpc["terminal_synthesis"]
        self.estimator = part("estimators", upd["mode"], root)
        # the weights as the configuration's dtype holds them
        self.store = getattr(torch, rc["dtype"])
        self._g = part("lifts", rc["lift"]["kind"], root).dictionary(
            rc["lift"], root, self.store, self.kw)
        self.r_state = torch.zeros(self.n, **self.kw)
        self.r_state[0] = rc["reference_value"]
        self.x, self.y, self.u = self.snapshots()
        self.norm = None
        if rc["lift"]["normalize"]:
            z = self.lift(self.x)
            self.norm = (z.mean(0), torch.clamp(z.std(0, correction=0),
                                                 min=1e-6))
        self.nlift = self.lift(self.x[:1]).shape[-1]
        self.model0, self.grams = self.fit()

    # -- inputs and set-up -------------------------------------------------

    def theta(self, th0: Dict[str, Tensor], th1: Dict[str, Tensor],
              step: int) -> Dict[str, Tensor]:
        """The plant's parameters at ``step``: the switched ones strictly
        after ``switch_step``."""
        return th1 if step > self.switch else th0

    def plant_step(self, x: Tensor, u: Tensor, th: Dict[str, Tensor]) -> Tensor:
        return self._plant(x, u, th)

    def snapshots(self) -> Tuple[Tensor, Tensor, Tensor]:
        data = self.rc["data"]
        gen = torch.Generator().manual_seed(self.rc["seed"])
        draw = lambda shape, lo, hi: (
            torch.rand(shape, generator=gen, dtype=self.store) * (hi - lo) + lo)
        nt, ns = data["n_traj"], data["n_step"]
        u_seq = draw((nt, ns, self.m), *data["u_range"]).to(**self.kw)
        x = draw((nt, self.n), *data["x0_range"]).to(**self.kw)
        th = {k: torch.tensor(v, **self.kw) for k, v in self.theta0.items()}
        xs, ys = [], []
        for t in range(ns):
            x_next = self.plant_step(x, u_seq[:, t], th)
            xs.append(x)
            ys.append(x_next)
            x = x_next
        flat = lambda s: torch.stack(s, 1).reshape(-1, self.n)
        return flat(xs), flat(ys), u_seq.reshape(-1, self.m)

    def lift(self, x: Tensor) -> Tensor:
        lc = self.rc["lift"]
        g = self._g(self.prec.mm, x)
        if lc["zero_offset"]:
            g = g - self._g(self.prec.mm, torch.zeros(self.n, **self.kw))
        if lc["state_augmented"]:
            g = torch.cat([x, g], dim=-1)
        if self.norm is not None:
            g = (g - self.norm[0]) / self.norm[1]
        return g

    def pinv(self, a: Tensor) -> Tensor:
        rtol = 10.0 * max(a.shape[-2:]) * torch.finfo(self.store).eps
        return torch.linalg.pinv(a, rtol=rtol)

    def fit(self):
        mm = self.prec.mm
        zx, zy = self.lift(self.x), self.lift(self.y)
        v = torch.cat([zx, self.u], dim=-1)
        grams = dict(syv=mm(_t(zy), v), gvv=mm(_t(v), v),
                     sxz=mm(_t(self.x), zx), gzz=mm(_t(zx), zx))
        k_ext = mm(grams["syv"], self.pinv(grams["gvv"]))
        c = mm(grams["sxz"], self.pinv(grams["gzz"]))
        nz = self.nlift
        return (k_ext[:, :nz], k_ext[:, nz:], c), grams

    # -- estimator ----------------------------------------------------------

    def estimator0(self, batch: int) -> Dict[str, Tensor]:
        """The estimator of ``batch`` scenarios before their first
        observation."""
        return self.estimator.init(self, batch)

    def estimator_from(self, fields: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """A batch of the program's estimator states, given by their
        fields."""
        return self.estimator.from_fields(self, fields)

    def model_of(self, est: Dict[str, Tensor]) -> Model:
        return self.estimator.model_of(self, est)

    def update(self, est: Dict[str, Tensor], model: Model, z: Tensor,
               u: Tensor, z_next: Tensor, c_target: Tensor):
        """One observation per scenario: (estimator, guarded model)."""
        new = self.estimator.observe(self, est, z, u, z_next, c_target)
        cand = self.model_of(new)
        guard = self.eng["model_guard"]
        if guard > 0.0:
            sane = _finite(*cand) & (self.radius(cand[0]) < guard)
            cand = tuple(_pick(sane, a, b) for a, b in zip(cand, model))
            keep = _finite(*(t for k, t in new.items() if k != "count"))
            new = {k: _pick(keep.to(t.device), t, est[k])
                   for k, t in new.items()}
        return new, cand

    def radius(self, a: Tensor, iters: int = 12) -> Tensor:
        """|lambda_max(A)| by power iteration from the uniform vector."""
        v = torch.full(a.shape[:-1], a.shape[-1] ** -0.5, **self.kw)
        nrm = torch.zeros(a.shape[:-2], **self.kw)
        for _ in range(iters):
            av = self.prec.mm(a, v.unsqueeze(-1)).squeeze(-1)
            nrm = torch.linalg.vector_norm(av, dim=-1)
            v = av / torch.clamp(nrm, min=1e-30)[..., None]
        return nrm

    # -- control ------------------------------------------------------------

    def cert0(self, batch: int) -> Cert:
        """The certificate before a synthesis passes: (Q_lift, 0, 1)."""
        return (self.q_lift().expand(batch, self.nlift, self.nlift),
                torch.zeros(batch, self.m, self.nlift, **self.kw),
                torch.ones(batch, **self.kw))

    def q_lift(self) -> Tensor:
        diag = torch.zeros(self.nlift, **self.kw)
        diag[: self.n] = self.q_w
        return torch.diag(diag)

    def certificate(self, model: Model) -> Cert:
        """The DARE certificate by doubling, K in the u = K z convention."""
        a, b, _ = model
        mm = self.prec.mm
        q = self.q_lift()
        r = self.r_w * torch.eye(self.m, **self.kw)
        eye = torch.eye(self.nlift, **self.kw)
        g = mm(b, mm(torch.linalg.inv(r), _t(b)))
        ak, gk, hk = a, g, q.expand_as(a)
        for _ in range(self.eng["dare_iters"]):
            w = _solve(eye + mm(gk, hk), ak)
            a_next = mm(ak, w)
            g_next = gk + mm(mm(ak, gk), _solve(eye + mm(hk, gk), _t(ak)))
            h_next = hk + mm(mm(_t(w), hk), ak)
            ak, gk, hk = a_next, g_next, h_next
        p = hk
        btp = mm(_t(b), p)
        k = _solve(r + mm(btp, b), mm(btp, a))
        return p, -k, p.diagonal(dim1=-2, dim2=-1).sum(-1)

    def held(self, model: Model, x: Tensor, cert: Cert) -> Cert:
        """The certificate held after a step at state x: this step's
        synthesis from ``model`` where it passes the guard, else ``cert``."""
        new = self.certificate(model)
        psi = self.lift(x - self.r_state)
        v = (self.prec.mm(psi.unsqueeze(-2), new[0]).squeeze(-2) * psi).sum(-1)
        ok = _finite(*new) & (v >= 0) & (new[2] > 0)
        return tuple(_pick(ok, p, q) for p, q in zip(new, cert))

    def control(self, model: Model, z: Tensor, x: Tensor, warm_x: Tensor,
                cert: Cert = ()):
        """The applied input of each scenario: (u, next primal warm start,
        held certificate)."""
        a, b, c = model
        mm, kw = self.prec.mm, self.kw
        batch, horizon, m, n = z.shape[0], self.horizon, self.m, self.n
        eng = self.eng
        qbar = torch.kron(torch.eye(horizon, **kw),
                          self.q_w * torch.eye(n, **kw)).expand(batch, -1, -1)
        if self.synthesis:
            cert = self.held(model, x, cert)
            qbar = qbar.clone()
            qbar[:, -n:, -n:] = mm(mm(c, cert[0]), _t(c))
        rbar = torch.kron(torch.eye(horizon, **kw), self.r_w * torch.eye(m, **kw))
        # F1 rows C A^(j+1), F2 blocks C A^(i-j) B (i >= j)
        rows, markov, g = [], [], c
        for _ in range(horizon):
            markov.append(mm(g, b))
            g = mm(g, a)
            rows.append(g)
        f1 = torch.cat(rows, dim=-2)
        f2 = torch.zeros(batch, horizon * n, horizon * m, **kw)
        for i in range(horizon):
            for j in range(i + 1):
                f2[:, i * n:(i + 1) * n, j * m:(j + 1) * m] = markov[i - j]
        fc = eng["f_clamp"]
        f1, f2 = (torch.nan_to_num(f, nan=0.0, posinf=fc, neginf=-fc).clamp(-fc, fc)
                  for f in (f1, f2))
        yr = self.r_state.repeat(horizon)
        h = mm(mm(_t(f2), qbar), f2) + rbar
        h = 0.5 * (h + _t(h))
        p = 2.0 * h
        err = mm(f1, z.unsqueeze(-1)).squeeze(-1) - yr
        q = 2.0 * mm(_t(f2), mm(qbar, err.unsqueeze(-1))).squeeze(-1)
        nx = horizon * m
        sigma, alpha = eng["qp_sigma"], eng["qp_alpha"]
        rho = self.rc["mpc"]["qp_rho"] * torch.clamp(
            p.diagonal(dim1=-2, dim2=-1).sum(-1) / nx, min=1e-6)
        kkt = p + (sigma + rho)[:, None, None] * torch.eye(nx, **kw)
        minv = torch.linalg.inv(kkt)
        lo, hi = self.u_min, self.u_max
        x_it, y = warm_x, torch.zeros_like(warm_x)
        zq = torch.clamp(x_it, lo, hi)
        rho_c = rho[:, None]
        for _ in range(self.rc["mpc"]["qp_iters"]):
            rhs = sigma * x_it - q + rho_c * zq - y
            xt = mm(minv, rhs.unsqueeze(-1)).squeeze(-1)
            x_mid = alpha * xt + (1.0 - alpha) * zq
            z_new = torch.clamp(x_mid + y / rho_c, lo, hi)
            y = y + rho_c * (x_mid - z_new)
            x_it, zq = xt, z_new
        clean = lambda t: torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)
        u = torch.clamp(clean(zq[:, :m]), lo, hi)
        warm = clean(torch.cat([zq[:, m:], zq[:, -m:]], dim=-1))
        return u, warm, cert
