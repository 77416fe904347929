"""The Revise_2 loops of koopmanx_torch against the JAX package: the
per-step DARE terminal synthesis with its certificate guard and the
monitor series in the closed loop (``revise2_duffing``: output tracking,
the SM RLS warm-started from the batch Grams; ``revise2_vdp``: lifted
tracking with the full P injected), the one-state ``toy1d`` loop, the
guard on a model with no certificate, one control solve under synthesis
with a held certificate, and the LMI terminal building. One JAX pipeline
(30x30 data) is carried across with ``convert.pipeline_from_numpy``;
float64 on the CPU, B = 4 scenarios from numpy with a seed, the kernel
route (its plain version on CPU tensors)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.run import _ref_fn as j_ref_fn  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.loop import REVISE2_FIELDS  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.lifts.base import constant_augmented  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import (  # noqa: E402
    engine_config,
    ref_fn_for,
    replicate,
    resolve_weights_path,
)
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

from test_torch_vdp import (  # noqa: E402
    BATCH,
    VDP,
    arrays_from_jax,
    assert_logs_match,
    run_both,
)

F64 = torch.float64
HORIZON = 10
PLANTS = {
    "duffing": (jlib.DuffingParams, tlib.DuffingParams,
                list(jlib.DUFFING.theta0), list(jlib.DUFFING.theta1)),
    "vanderpol": VDP,
    "toy1d": (jlib.Toy1dParams, tlib.Toy1dParams, list(jlib.TOY1D.theta0),
              list(jlib.TOY1D.theta1)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(name, steps):
    """The preset of both packages at test size: ``steps`` steps with the
    switch at steps/2, 30x30 data with the preset's ranges, float64,
    horizon 10, the kernel route; JAX loads the file the port resolves
    (the in-repo artifact, or a random init for toy1d)."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.PRESETS[name]()
        cfg.steps, cfg.dtype, cfg.switch_step = steps, "float64", steps // 2
        cfg.mpc.horizon, cfg.mpc.qp_backend = HORIZON, "pallas"
        cfg.data = dataclasses.replace(cfg.data, n_step=30, n_traj=30)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jcfg.lift.weights_path = resolve_weights_path(tcfg.lift.weights_path,
                                                  tcfg.system)
    return jcfg, tcfg


def assert_monitors_match(jlogs, log, rtol=1e-8):
    """Every Revise_2 monitor field per scenario and step within ``rtol``
    of max(1, |JAX's value|), or within ten times the JAX package's own
    divergence there (up to that step) from one ulp of x0 and, where
    ``jlogs`` has a fourth log, from one ulp of the initial model's A,
    where that is larger: the DARE of a nearly uncontrollable lifted model
    amplifies round-off (gamma reaches 1e8 on revise2_vdp), which a nudged
    x0 does not reach before the model moves. The same NaN pattern;
    ``cert_fresh`` equal. Returns the largest relative differences."""
    jlog, *jfloors = jlogs
    out = {}
    for k in REVISE2_FIELDS:
        got, ref = getattr(log, k).numpy(), np.asarray(getattr(jlog, k))
        assert got.shape == ref.shape, k
        if k == "cert_fresh":
            np.testing.assert_array_equal(got, ref)
            continue
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), k)
        flat = lambda v: np.nan_to_num(v).reshape(v.shape[:2] + (-1,))
        diff = np.abs(flat(got) - flat(ref)).max(-1)
        floor = np.maximum.accumulate(np.max(
            [np.abs(flat(np.asarray(getattr(f, k))) - flat(ref)).max(-1)
             for f in jfloors], axis=0), axis=1)
        scale = np.maximum(1.0, np.abs(flat(ref)).max(-1))
        assert (diff <= np.maximum(rtol * scale, 10.0 * floor)).all(), (
            k, diff.max(), floor.max())
        out[k] = float((diff / scale).max())
    return out


@pytest.mark.parametrize("name,steps", [("revise2_duffing", 12),
                                        ("revise2_vdp", 16),
                                        ("toy1d", 16)])
def test_revise2_loop_matches_jax_run_batch(name, steps):
    """4 scenarios through the switch at steps/2, float64, against JAX
    ``run_batch`` on one pipeline: x to 1e-9 and u to 1e-8, the monitor
    series to 1e-8 relative, each per scenario and step or within ten
    times JAX's own one-ulp-of-x0 floor there (the VDP loop is chaotic at
    round-off; for the monitors also from one ulp of the initial A,
    ``assert_monitors_match``); ``cert_fresh`` equal. Under synthesis
    every step passes
    the guard on these healthy models, the held certificate is finite,
    and V, gamma > 0; toy1d (no synthesis) logs zeros and cert_fresh True
    everywhere; |u| within the box."""
    jcfg, tcfg = configs(name, steps)
    system = tlib.get_system(tcfg.system)
    jlogs, log, carry, pipe = run_both(jcfg, tcfg, PLANTS[tcfg.system],
                                       n=system.n, nudge_model=True)
    assert_logs_match(jlogs[:3], log)
    assert_monitors_match(jlogs, log)
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
    fresh = log.cert_fresh.numpy()
    if tcfg.mpc.terminal_synthesis:
        assert fresh.all()
        assert all(bool(torch.isfinite(t).all()) for t in carry.cert)
        assert (log.gamma.numpy() > 0).all()
        assert (log.lyapunov.numpy() >= 0).all()
        nlift = pipe.dictionary.nlift
        py = nlift if tcfg.mpc.track_lifted else system.n
        assert log.ellipse.shape == (BATCH, steps, py, py)
        assert carry.cert[0].shape == (BATCH, nlift, nlift)
    else:
        assert carry.cert == () and fresh.all()
        for k in REVISE2_FIELDS[:-1]:
            assert not getattr(log, k).any(), k


def test_certificate_guard_holds_on_a_model_with_no_certificate():
    """``revise2_duffing`` with a NaN entry in every scenario's initial A
    and the estimator off (the model stays broken): the synthesis fails
    every step, so ``cert_fresh`` is False throughout and the seed
    certificate (P = Q_lift, K = 0, gamma = 1) is held; the Lyapunov value
    and gamma stay finite, as in JAX (``tests/test_engine.py::
    test_certificate_guard_holds_on_synthesis_failure``); x, u and every
    monitor match JAX ``run_batch``, NaN pattern included."""
    jcfg, tcfg = configs("revise2_duffing", 8)
    for cfg in (jcfg, tcfg):
        cfg.update.mode = "off"
    jpipe = j_build_pipeline(jcfg)
    jpipe = jpipe._replace(model0=jpipe.model0._replace(
        A=jpipe.model0.A.at[0, 0].set(jnp.nan)))
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-2.0, 2.0, size=(BATCH, 2))
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    jrun = jax.jit(lambda x: j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params), x,
        jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0))[1])
    jlogs = tuple(jrun(jnp.asarray(x)) for x in (
        x0, np.nextafter(x0, 9.0), np.nextafter(x0, -9.0)))
    carry, log = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH))
    assert not log.cert_fresh.any()
    assert torch.isfinite(log.lyapunov).all()
    assert torch.isfinite(log.gamma).all()
    p, k, gamma = carry.cert
    np.testing.assert_array_equal(
        p.numpy(), np.broadcast_to(pipe.params.q_lift.numpy(), p.shape))
    assert not k.any() and (gamma == 1).all()
    assert_logs_match(jlogs, log)
    assert_monitors_match(jlogs, log)


def _jax_certs(cert):
    return tuple(jnp.asarray(v) for v in cert)


@pytest.mark.parametrize("name", ["revise2_duffing", "revise2_vdp"])
def test_synthesis_control_solve_matches_jax(name):
    """One control solve under terminal synthesis for 6 scenarios whose
    models are the pipeline's initial model with per-scenario noise (one
    with a NaN in A, whose certificate the guard holds), each with its own
    previous certificate and state, against JAX's ``make_control_solver``
    on the same reference: u, the warm start, the held certificate, the
    guard's verdict, the anchor, the injected terminal block (C P C', or
    the full P under lifted tracking) and its output map, each scenario
    within 1e-9 of max(1, its largest |entry|) or ten times JAX's own
    change when the models' A move by one ulp, where that is larger (the
    lifted models' DARE amplifies round-off to ~1e-7 relative in u)."""
    jcfg, tcfg = configs(name, 4)
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    rng = np.random.default_rng(13)
    b, nz, m = 6, pipe.dictionary.nlift, 1
    a0, b0, c0 = (np.asarray(v) for v in jpipe.model0)
    model = [a0 + 0.01 * rng.normal(size=(b, nz, nz)),
             b0 + 0.05 * rng.normal(size=(b,) + b0.shape),
             c0 + 0.05 * rng.normal(size=(b,) + c0.shape)]
    model[0][2, 1, 1] = np.nan
    q_lift = np.asarray(jpipe.params.q_lift)
    cert = (q_lift * rng.uniform(1, 2, size=(b, 1, 1)),
            rng.normal(size=(b, m, nz)), rng.uniform(1, 5, size=(b,)))
    x = rng.uniform(-2.0, 2.0, size=(b, 2))
    z = np.asarray(jax.vmap(jpipe.dictionary)(jnp.asarray(x)))
    warm = rng.uniform(-1.0, 1.0, size=(b, HORIZON * m))
    step = 3
    jsolve = jcore.make_control_solver(
        jpipe.dictionary, jpipe.engine_cfg,
        j_ref_fn(jcfg, jpipe.dictionary, jpipe.params.q_block.shape[0],
                 jnp.float64), m)
    jrun = jax.jit(jax.vmap(lambda mdl, ct, xx, zz, wx: jsolve(
        jpipe.params, mdl, ct, xx, zz, jnp.zeros(m), wx, (),
        jnp.asarray(step))))
    fields = lambda d: [d.u_applied, d.warm_x, *d.cert, d.ref_full,
                        d.terminal, d.c_for_term]
    jdecs = [jrun(JModel(jnp.asarray(a), *(jnp.asarray(v)
                                          for v in model[1:])),
                  _jax_certs(cert), jnp.asarray(x), jnp.asarray(z),
                  jnp.asarray(warm))
             for a in (model[0], np.nextafter(model[0], 9.0))]
    tsolve = tcore.make_control_solver(
        pipe.engine_cfg, ref_fn_for(tcfg, pipe.params.q_block.shape[-1],
                                    "cpu", pipe.dictionary), m,
        pipe.dictionary)
    with torch.no_grad():
        tdec = tsolve(replicate(pipe.params, b),
                      TModel(*(torch.tensor(v) for v in model)),
                      torch.tensor(z), torch.zeros(b, m, dtype=F64),
                      torch.tensor(warm), (), step,
                      tuple(torch.tensor(v) for v in cert), torch.tensor(x))
    ok = tdec.cert_ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jdecs[0].cert_ok))
    assert not ok[2] and ok.sum() == b - 1
    for got, want, nudged in zip(*(fields(d) for d in (tdec, *jdecs))):
        # the lifted output map is one identity for every scenario
        got = np.broadcast_to(np.asarray(got), np.asarray(want).shape)
        got, want, nudged = (np.asarray(v).reshape(b, -1)
                             for v in (got, want, nudged))
        assert np.isfinite(got).all()
        diff = np.abs(got - want).max(-1)
        bound = np.maximum(1e-9 * np.maximum(1.0, np.abs(want).max(-1)),
                           10.0 * np.abs(nudged - want).max(-1))
        assert (diff <= bound).all(), (diff, bound)
    for t, c in zip(tdec.cert, cert):
        np.testing.assert_array_equal(t.numpy()[2], c[2])
    assert float(tdec.u_applied.abs().max()) <= tcfg.mpc.u_max


def test_lmi_terminal_stays_refused():
    """``terminal_mode='lmi'`` under synthesis (ROADMAP item 14b) is ported:
    ``engine_config`` and the engine build it, and its loop matches JAX
    (tests/test_torch_lmi.py); an unknown mode is a ValueError, as it
    was. The DARE mode builds."""
    cfg = TC.revise2_duffing_preset()
    engine_config(cfg)
    cfg.mpc.terminal_mode = "lmi"
    assert engine_config(cfg).terminal_mode == "lmi"
    solve = tcore.make_control_solver(
        tcore.EngineConfig(terminal_synthesis=True, terminal_mode="lmi"),
        lambda step: None, 1, constant_augmented(2))
    assert callable(solve)
    with pytest.raises(ValueError, match="terminal_mode"):
        tcore.check_supported(tcore.EngineConfig(terminal_mode="sdp"))
