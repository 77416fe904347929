"""The slice as a whole: the batched Duffing closed loop of koopmanx_torch
against JAX ``run_batch`` on the same pipeline, carried across as numpy
arrays (``koopmanx_torch.convert``), plus the engine's per-scenario guard
and reset against their JAX counterparts. float64 on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.edmd import rls as jrls  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.eval.metrics import steady_state_error, tracking_mse  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
BATCH, STEPS = 4, 80


def _configure(cfg, lift_cls, data_cls):
    """The slice at test size: horizon 10, hidden 16, data 20x20, switch
    at 40, f64, the kernel route (JAX on the CPU takes its plain vmap
    fallback there, with the same block-8 KKT as the port)."""
    cfg.steps = STEPS
    cfg.dtype = "float64"
    cfg.switch_step = STEPS // 2
    cfg.mpc.horizon = 10
    cfg.mpc.qp_backend = "pallas"
    cfg.data = data_cls(n_step=20, n_traj=20)
    cfg.lift = lift_cls(kind="mlp", nlift=8, hidden=16)
    return cfg


def _arrays_from_jax(pipe):
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    p = pipe.params
    return {
        "mlp": [tuple(layer) for layer in n(pipe.dictionary.params)],
        "normalizer": None,
        "model0": tuple(n(pipe.model0)),
        "rls0": n(pipe.rls0._asdict()),
        "params": {"q_block": n(p.q_block), "r_block": n(p.r_block),
                   "u_min": n(p.u_min), "u_max": n(p.u_max), "cy": None,
                   "ref_state": n(p.ref_state)},
        "x_init": n(pipe.x_init),
    }


@pytest.fixture(scope="module")
def jax_pipe():
    return j_build_pipeline(_configure(JC.duffing_nn_preset(), JC.LiftConfig,
                                       JC.DataConfig))


@pytest.fixture(scope="module")
def scenarios():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2, 2, size=(BATCH, 2))
    th0 = np.array([-0.5, 1.0, -1.0]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    th1 = np.array([-5.0, 2.0, -0.5]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    return x0, th0, th1


def test_pipeline_from_numpy_round_trip(jax_pipe):
    arrays = _arrays_from_jax(jax_pipe)
    cfg = _configure(TC.duffing_nn_preset(), TC.LiftConfig, TC.DataConfig)
    pipe = pipeline_from_numpy(arrays, cfg, device="cpu", dtype=F64)
    back = pipeline_to_numpy(pipe)
    for (w, b), (w2, b2) in zip(arrays["mlp"], back["mlp"]):
        np.testing.assert_array_equal(w, w2)
        np.testing.assert_array_equal(b, b2)
    for a, b in zip(arrays["model0"], back["model0"]):
        np.testing.assert_array_equal(a, b)
    for k, v in arrays["rls0"].items():
        np.testing.assert_array_equal(v, back["rls0"][k])
    for k in ("q_block", "r_block", "u_min", "u_max", "ref_state"):
        np.testing.assert_array_equal(arrays["params"][k], back["params"][k])
    assert back["params"]["cy"] is None
    x = np.random.default_rng(1).uniform(-2, 2, size=(8, 2))
    with torch.no_grad():
        z = pipe.dictionary(torch.tensor(x)).numpy()
    np.testing.assert_allclose(z, np.asarray(jax_pipe.dictionary(jnp.asarray(x))),
                               rtol=0, atol=1e-12)


def _quality(x, r, tail=20):
    """Batch-mean tracking MSE and steady-state error on channel 0."""
    mse = np.mean([float(tracking_mse(x[b, :, 0], r[b, :, 0]))
                   for b in range(x.shape[0])])
    sse = np.mean([float(steady_state_error(x[b, :, 0], r[b, :, 0], tail))
                   for b in range(x.shape[0])])
    return mse, sse


def test_slice_matches_jax_run_batch(jax_pipe, scenarios):
    """4 scenarios x 80 steps with a live switch at 40: the first 16 steps
    to 1e-9 (the same f64 arithmetic up to summation order), then control
    quality to 1e-3 relative (the gate pattern of
    tests/test_kkt_refine.py:71-88: round-off seeds can grow through the
    scratch-RLS warm-up)."""
    x0, th0, th1 = scenarios
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    _, jlog = j_run_batch(
        jax_pipe.closed_loop,
        jax.tree_util.tree_map(rep, jax_pipe.params), jnp.asarray(x0),
        jax.tree_util.tree_map(rep, jax_pipe.model0),
        jax.tree_util.tree_map(rep, jax_pipe.rls0),
        JDuffing(*jnp.asarray(th0.T)), JDuffing(*jnp.asarray(th1.T)),
    )
    cfg = _configure(TC.duffing_nn_preset(), TC.LiftConfig, TC.DataConfig)
    pipe = pipeline_from_numpy(_arrays_from_jax(jax_pipe), cfg, device="cpu",
                               dtype=F64)
    launches = box_admm.launches
    _, tlog = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
        TDuffing(*torch.tensor(th0.T)), TDuffing(*torch.tensor(th1.T)),
    )
    assert box_admm.launches == launches  # CPU tensors: no kernel launch
    jx, tx = np.asarray(jlog.x), tlog.x.numpy()
    assert tx.shape == jx.shape == (BATCH, STEPS, 2)
    assert np.abs(tx[:, :16] - jx[:, :16]).max() <= 1e-9
    np.testing.assert_allclose(tlog.u.numpy()[:, :16], np.asarray(jlog.u)[:, :16],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tlog.residual.numpy()[:, :16],
                               np.asarray(jlog.residual)[:, :16], rtol=0,
                               atol=1e-9)
    jm, js = _quality(jx, np.asarray(jlog.r))
    tm, ts = _quality(tx, tlog.r.numpy())
    assert abs(tm - jm) <= 1e-3 * max(jm, 1e-9), (tm, jm)
    assert abs(ts - js) <= 1e-3 * max(js, 1e-9) or abs(ts - js) < 1e-6, (ts, js)
    assert np.abs(tlog.u.numpy()).max() <= 2.0


def test_model_guard_per_scenario_matches_jax():
    """One scenario's observation is non-finite: only that scenario holds
    its model and estimator, in both packages."""
    rng = np.random.default_rng(2)
    nlift, m, n, b = 4, 1, 2, 3
    z, zn = rng.normal(size=(b, nlift)), rng.normal(size=(b, nlift))
    u, x = rng.normal(size=(b, m)), rng.normal(size=(b, n))
    zn[1, 0] = np.nan
    a0 = 0.5 * np.eye(nlift) + 0.05 * rng.normal(size=(b, nlift, nlift))
    b0, c0 = rng.normal(size=(b, nlift, m)), rng.normal(size=(b, n, nlift))
    jcfg = jcore.EngineConfig(update="rls_sqrt", rls_ridge=1e-2)
    jupd = jcore.make_estimator_update(type("D", (), {"nlift": nlift})(), jcfg)
    js0 = jrls.sqrt_rls_init(nlift, m, n, 1e4, 1e2, dtype=jnp.float64)
    jr, jm = jax.vmap(lambda s, mm, *a: jupd(s, mm, *a, 0),
                      in_axes=(None, 0, 0, 0, 0, 0))(
        js0, JModel(*(jnp.asarray(v) for v in (a0, b0, c0))),
        *(jnp.asarray(v) for v in (z, u, zn, x)))
    tcfg = tcore.EngineConfig(update="rls_sqrt", rls_ridge=1e-2)
    tupd = tcore.make_estimator_update(type("D", (), {"nlift": nlift})(), tcfg)
    ts0 = replicate(trls.sqrt_rls_init(nlift, m, n, 1e4, 1e2, dtype=F64), b)
    tr, tm = tupd(ts0, TModel(*(torch.tensor(v) for v in (a0, b0, c0))),
                  *(torch.tensor(v) for v in (z, u, zn, x)), 0)
    # two triangular solves against factors of condition ~1e2: 1e-10
    for t, j in zip(list(tm) + list(tr), list(jm) + list(jr)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tm.A[1].numpy(), a0[1])  # held
    assert int(tr.count[1]) == 0 and int(tr.count[0]) == 1


def test_change_reset_matches_jax():
    rng = np.random.default_rng(3)
    b, nlift, m, n = 4, 4, 1, 2
    state = trls.SqrtRLSState(
        K_A=torch.tensor(rng.normal(size=(b, nlift, nlift + m))),
        r_g=torch.tensor(rng.normal(size=(b, nlift + m, nlift + m))),
        barX=torch.tensor(rng.normal(size=(b, n, nlift))),
        r_q=torch.tensor(rng.normal(size=(b, nlift, nlift))),
        count=torch.zeros(b, dtype=torch.int32),
    )
    ema = np.array([0.0, 1.0, 1.0, 2.0])
    res = np.array([5.0, 1.1, 9.0, 2.5])
    jcfg = jcore.EngineConfig(update="rls_sqrt", reset_mult=3.0)
    tcfg = tcore.EngineConfig(update="rls_sqrt", reset_mult=3.0)
    js = jrls.SqrtRLSState(*(jnp.asarray(v.numpy()) for v in state))
    jr, je = jax.vmap(lambda s, e, r: jcore.change_reset(jcfg, s, e, r))(
        js, jnp.asarray(ema), jnp.asarray(res))
    tr, te = tcore.change_reset(tcfg, state, torch.tensor(ema),
                                torch.tensor(res))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-15)
    for t, j in zip(tr, jr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-15)


def test_build_pipeline_runs_the_flagship_loop_small_on_cpu():
    """The port's own setup (collect, He-init lift, pinv fit) and the
    flagship loop at a tiny size: finite, inside the box, shaped."""
    cfg = TC.flagship_config(steps=12, horizon=5)
    cfg.data = dataclasses.replace(cfg.data, n_step=10, n_traj=10)
    cfg.lift.hidden = 8
    pipe = t_build_pipeline(cfg, device="cpu")
    assert pipe.model0.A.shape == (8, 8) and pipe.rls0.r_g.shape == (9, 9)
    x0 = torch.tensor(np.random.default_rng(4).uniform(-2, 2, (3, 2)),
                      dtype=torch.float32)
    carry, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, 3), x0,
                             replicate(pipe.model0, 3),
                             replicate(pipe.rls0, 3))
    assert log.x.shape == (3, 12, 2) and log.u.shape == (3, 12, 1)
    assert torch.isfinite(log.x).all() and log.u.abs().max() <= 2.0
    assert carry.rls.count.tolist() == [12, 12, 12]


def test_unported_options_raise():
    """Options of earlier ROADMAP items, now ported, build and run. The
    polynomial and identity lifts (L7, tests/test_torch_poly_markov.py),
    the LMI terminal (item 14b) and the LQR controller (item 15,
    tests/test_torch_lmi.py, tests/test_torch_lqr.py): on the same tank
    config each builds and runs two steps with finite inputs in the box,
    none launching the kernel on CPU tensors. The Woodbury lane, a
    compressed ring, k-means centers and Fourier lifts (item 11) are ported
    (tests/test_torch_rbf128.py), and so are the explicit applied-window
    rows and the state box (item 12, tests/test_torch_general_qp.py), the
    storage-method update and lifted tracking (item 13,
    tests/test_torch_estimators.py, tests/test_torch_vdp.py), and the DARE
    terminal synthesis (item 14a, tests/test_torch_revise2.py)."""
    cases = [({"terminal_synthesis": True, "terminal_mode": "lmi"}, {}),
             ({}, {"kind": "hermite"}),
             ({}, {"kind": "identity"}),
             ({"controller": "lqr"}, {})]
    for mpc, lift in cases:
        cfg = TC.tank_bench_config(steps=2)
        cfg.data = dataclasses.replace(cfg.data, n_step=5, n_traj=5)
        cfg.mpc = dataclasses.replace(cfg.mpc, **mpc)
        cfg.lift = dataclasses.replace(cfg.lift, **lift)
        if mpc.get("controller") == "lqr":
            # the LQR law has no du formulation (a ValueError, as in JAX)
            cfg.mpc = dataclasses.replace(cfg.mpc, delta_u=False)
        pipe = t_build_pipeline(cfg, device="cpu")
        launches = box_admm.launches
        x0 = torch.full((2, 2), 0.5)
        _, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, 2),
                             x0, replicate(pipe.model0, 2),
                             replicate(pipe.rls0, 2))
        assert torch.isfinite(log.u).all() and log.u.shape == (2, 2, 1)
        assert float(log.u.abs().max()) <= 8.0
        assert box_admm.launches == launches
