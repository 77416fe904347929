"""The comparison that decides ``correct``, and the check that the run
loaded no JAX.

The reference (:mod:`benchmark.reference`) works out again, for a sample
of scenarios, what the timed path produced over two stretches of it:

- ``start``: the first steps of an episode (the first calls of a fleet),
  from the reference's own set-up: its own snapshots, lift, EDMD fit and
  estimator prior, and the episode's initial states;
- ``last``: the last stretch of the window, from the program's own state
  at its start (its model, estimator, warm start and certificate), which
  the reference reads as it would read a checkpoint.

Over a stretch the reference reads the measured states and the applied
inputs that the program produced (the observations its estimator saw),
and compares these numbers, each the widest gap over the sampled
scenarios:

- ``u``: |u_program - u_reference| of the stretch's first step, the
  control solve (with the synthesis, the condensed QP and the ADMM) from
  the stretch's state;
- ``res``: the lifted one-step residual ||psi(x+) - (A psi(x) + B u)|| the
  program logged at the first step against the reference's, whose x+ is
  its own RK4 step, as a share of ||psi(x+)||: the lift and the plant;
- ``gamma``, ``ellipse``: the held certificate's level and C P C' / gamma
  at the first step, relative gaps (terminal synthesis only);
- ``cert_p``, ``cert_k``: the certificate the program holds after the
  ``last`` stretch, its P and its gain K, against the one the reference
  holds after synthesizing, step by step, from the models its replay of
  the stretch's observations gives, relative gaps (terminal synthesis
  only; at an episode's start the control's own set-up drifts too far for
  a limit between it and the program's, and ``gamma``, ``ellipse`` hold
  the certificate there);
- ``est``: the estimator's state after the stretch's observations (the
  Grams of [z u] and z, or their inverses, K_A and barX), the worst
  leaf's relative gap;
- ``model``: the model after the stretch against the one the reference
  extracts from the program's estimator state, by their predictions
  A z + B u and C z at the stretch's last observation, on the scenarios
  where that model passes the guard (elsewhere the program holds an older
  model, which the reference does not see);
- ``lift``: the lift of the last measurement a fleet's state keeps;
- ``model0``, ``est0``: the set-up's EDMD fit, and the warm-started
  estimator, against the reference's own.
"""
from __future__ import annotations

import sys
from typing import Dict, Iterable, List

import torch
from torch import Tensor

FORBIDDEN = ("jax", "jaxlib", "flax", "koopmanx")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole: ``koopmanx_torch`` is not
    ``koopmanx``."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def rel_gap(p: Tensor, r: Tensor) -> Tensor:
    """Per scenario ||p - r||_F / ||r||_F over every axis but the first."""
    p, r = p.reshape(p.shape[0], -1), r.reshape(r.shape[0], -1)
    den = torch.clamp(torch.linalg.vector_norm(r, dim=-1), min=1e-30)
    return torch.linalg.vector_norm(p.to(r.dtype) - r, dim=-1) / den


def worst(*gaps: Tensor) -> float:
    """The largest entry of the gaps; NaN (a non-finite output) is inf."""
    out = 0.0
    for g in gaps:
        if g.numel():
            g = torch.nan_to_num(g.double(), nan=float("inf"))
            out = max(out, float(g.max()))
    return out


def _est_gap(ref, program: Dict[str, Tensor], est: Dict[str, Tensor]) -> float:
    mine = ref.estimator_from(program)
    return worst(*(rel_gap(mine[k], est[k]) for k in est if k != "count"))


def _model_gap(ref, program_model, program_est: Dict[str, Tensor],
               z: Tensor, u: Tensor) -> float:
    """The program's model against the one the reference extracts from the
    program's estimator state, by what each predicts at the stretch's last
    observation (z, u): A z + B u and C z, relative gaps, the worse of the
    two; on the scenarios whose extracted model passes the guard."""
    extracted = ref.model_of(ref.estimator_from(program_est))
    sane = ((ref.radius(extracted[0]) < ref.eng["model_guard"])
            & torch.stack([torch.isfinite(t.reshape(t.shape[0], -1)).all(-1)
                           for t in extracted]).all(0))
    mv = lambda m, v: ref.prec.mm(m, v.unsqueeze(-1)).squeeze(-1)

    def predict(model):
        a, b, c = (t.to(**ref.kw)[sane] for t in model)
        return mv(a, z[sane]) + mv(b, u[sane]), mv(c, z[sane])

    (zp, yp), (zr, yr) = predict(program_model), predict(extracted)
    return worst(rel_gap(zp, zr), rel_gap(yp, yr))


def _first_step(ref, s: Dict, model, warm, cert, prefix: str) -> Dict[str, float]:
    """``u``, ``res`` and, under synthesis, ``gamma`` and ``ellipse`` of
    the stretch's first step, from ``model``, ``warm`` and ``cert``."""
    x, u_p = s["x"][:, 0], s["u"][:, 0]
    z = ref.lift(x)
    u_r, _, cert_r = ref.control(model, z, x, warm, cert)
    out = {f"u.{prefix}": worst((u_r - u_p).abs())}
    if "residual" in s:
        th = ref.theta(s["th0"], s["th1"], s["step0"])
        z_next = ref.lift(ref.plant_step(x, u_p, th))
        a, b, _ = model
        pred = (ref.prec.mm(a, z.unsqueeze(-1)) + ref.prec.mm(b, u_p.unsqueeze(-1))).squeeze(-1)
        res_r = torch.linalg.vector_norm(z_next - pred, dim=-1)
        scale = torch.clamp(torch.linalg.vector_norm(z_next, dim=-1), min=1e-30)
        out[f"res.{prefix}"] = worst((s["residual"][:, 0] - res_r).abs() / scale)
    if ref.synthesis:
        c = model[2]
        ell = ref.prec.mm(ref.prec.mm(c, cert_r[0]), c.transpose(-1, -2))
        ell = ell / cert_r[2][:, None, None]
        out[f"gamma.{prefix}"] = worst(rel_gap(s["gamma"][:, :1], cert_r[2][:, None]))
        out[f"ellipse.{prefix}"] = worst(rel_gap(s["ellipse"][:, 0], ell))
    return out


def _replay(ref, est, model, xs: Tensor, us: Tensor, x_end: Tensor):
    """The estimator over a stretch of a loop's observations: step t sees
    (x_t, u_t, x_t+1), x_T = ``x_end``. Returns the estimator after the
    stretch and the model each step's control read (before its update)."""
    c_next = ref.rc["update"]["c_pairing"] == "next"
    steps, models = xs.shape[1], []
    for t in range(steps):
        x = xs[:, t]
        x_next = xs[:, t + 1] if t + 1 < steps else x_end
        models.append(model)
        est, model = ref.update(est, model, ref.lift(x), us[:, t],
                                ref.lift(x_next), x_next if c_next else x)
    return est, models


def _cert_gaps(ref, s: Dict, models, cert, prefix: str) -> Dict[str, float]:
    """``cert_p`` and ``cert_k``: the certificate held after the stretch,
    the reference's from ``cert`` and the replayed ``models`` at the
    program's states, against the program's."""
    for t, model in enumerate(models):
        cert = ref.held(model, s["x"][:, t], cert)
    p_prog, k_prog, _ = s["cert_end"]
    return {f"cert_p.{prefix}": worst(rel_gap(p_prog, cert[0])),
            f"cert_k.{prefix}": worst(rel_gap(k_prog, cert[1]))}


def setup_numbers(ref, sel: Dict) -> Dict[str, float]:
    out = {"model0": worst(*(rel_gap(p[None], r[None])
                             for p, r in zip(sel["model0"], ref.model0)))}
    if ref.rc["update"]["warm_start_from_batch"]:
        one = {k: v[None] for k, v in sel["est0"].items()}
        out["est0"] = _est_gap(ref, one, ref.estimator0(1))
    return out


def sweep_numbers(ref, sel: Dict) -> Dict[str, float]:
    """The numbers of a sweep: the set-up, and the ``start`` and ``last``
    stretches, each a dict of the sampled scenarios' tensors."""
    out = setup_numbers(ref, sel)
    for name in ("start", "last"):
        s = sel[name]
        batch = s["x"].shape[0]
        if s.get("est_in") is None:  # an episode's start: the reference's own
            est = ref.estimator0(batch)
            model = tuple(t.expand((batch,) + t.shape) for t in ref.model0)
            warm = torch.zeros(batch, ref.horizon * ref.m, **ref.kw)
            cert = ref.cert0(batch) if ref.synthesis else ()
        else:
            est = ref.estimator_from(s["est_in"])
            model = tuple(t.to(**ref.kw) for t in s["model_in"])
            warm = s["warm_in"].to(**ref.kw)
            cert = (tuple(t.to(**ref.kw) for t in s["cert_in"])
                    if ref.synthesis else ())
        out.update(_first_step(ref, s, model, warm, cert, name))
        est, models = _replay(ref, est, model, s["x"], s["u"], s["x_end"])
        if ref.synthesis and name == "last":
            out.update(_cert_gaps(ref, s, models, cert, name))
        out[f"est.{name}"] = _est_gap(ref, s["est_end"], est)
        out[f"model.{name}"] = _model_gap(ref, s["model_end"], s["est_end"],
                                          ref.lift(s["x"][:, -1]), s["u"][:, -1])
    return out


def serve_numbers(ref, sel: Dict) -> Dict[str, float]:
    """The numbers of a served fleet: the set-up, the ``start`` stretch
    (the window's first calls after a full reset) and the ``last``
    stretch (from a kept fleet state). A stretch holds the calls'
    measurements ``x`` (S, K, n) and inputs ``u`` (S, K, m), and the
    fleet's state before it, after its first call (``last`` only) and after
    it."""
    out = setup_numbers(ref, sel)
    c_next = ref.rc["update"]["c_pairing"] == "next"
    for name in ("start", "last"):
        s = sel[name]
        xs, us = s["x"], s["u"]
        batch, calls = xs.shape[:2]
        if s.get("est_in") is None:
            est = ref.estimator0(batch)
            model = tuple(t.expand((batch,) + t.shape) for t in ref.model0)
            warm = torch.zeros(batch, ref.horizon * ref.m, **ref.kw)
            have = torch.zeros(batch, dtype=torch.bool)
            z_prev = x_prev = u_prev = None
        else:
            est = ref.estimator_from(s["est_in"])
            model = tuple(t.to(**ref.kw) for t in s["model_in"])
            warm = s["warm_in"].to(**ref.kw)
            have = s["have_in"]
            z_prev, x_prev, u_prev = (s[k].to(**ref.kw) for k in
                                      ("z_prev_in", "x_prev_in", "u_prev_in"))
        for k in range(calls):
            x = xs[:, k]
            z = ref.lift(x)
            if z_prev is not None:
                new_est, new_model = ref.update(est, model, z_prev, u_prev, z,
                                                x if c_next else x_prev)
                est = {f: _pick_rows(have, new_est[f], est[f]) for f in est}
                model = tuple(_pick_rows(have, p, q)
                              for p, q in zip(new_model, model))
            if k == 0:
                # the first call's control: from the model the program's
                # own update gave it, where the stretch starts from the
                # program's state
                first = (model if s.get("model_first") is None else
                         tuple(t.to(**ref.kw) for t in s["model_first"]))
                u_r, _, _ = ref.control(first, z, x, warm)
                out[f"u.{name}"] = worst((u_r - us[:, 0]).abs())
            z_prev, x_prev, u_prev = z, x, us[:, k]
            have = torch.ones(batch, dtype=torch.bool)
        out[f"est.{name}"] = _est_gap(ref, s["est_end"], est)
        out[f"model.{name}"] = _model_gap(ref, s["model_end"], s["est_end"],
                                          ref.lift(xs[:, -1]), us[:, -1])
        out[f"lift.{name}"] = worst(rel_gap(s["z_prev_end"], ref.lift(xs[:, -1])))
    return out


def _pick_rows(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared is at most its limit; a number without a
    limit, or a limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in limits)
