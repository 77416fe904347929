"""The two-pump tank_mimo slice of koopmanx_torch against the JAX package:
the plant, the output-space (low-rank) KKT inverse, one control solve on
each route (the dense inverse and the box-ADMM kernel's plain version on
'pallas', the low-rank inverse and the plain ADMM on 'xla'), and the
batched closed loop (m = 2, windowed estimator, per-channel input box)
against JAX ``run_batch`` on both routes. float64 on the CPU; inputs from
numpy with a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control.qp import ADMMConfig as JADMM  # noqa: E402
from koopmanx.control.qp import _effective_rho as j_rho  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine import ref as jref  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.ops.linalg import spd_inverse as j_spd_inverse  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import base as jsys  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control.condensed import (  # noqa: E402
    block_diag_repeat,
    condensed_qp,
)
from koopmanx_torch.control.qp import box_kkt  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine import ref as tref  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.ops.linalg import spd_inverse  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate  # noqa: E402
from koopmanx_torch.systems import base as tsys  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
BATCH, STEPS, WINDOW = 4, 16, 32
NOMINAL = [0.5, 0.4, 0.2, 0.3, 0.25]
SWITCHED = [0.53, 0.3, 0.1, 0.35, 0.2]
ROUTES = ["pallas", "xla"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_plant_step_matches_jax():
    """One step at per-scenario parameters from levels at, below and above
    0, with inputs on both pumps that drain a tank: the same elementwise
    operations in both packages, 1e-12, clamped to x >= 0."""
    rng = np.random.default_rng(21)
    b = 32
    x = rng.uniform(-0.5, 2.0, size=(b, 2))
    x[0] = 0.0
    u = rng.uniform(-4.0, 4.0, size=(b, 2))
    th = np.array(NOMINAL) * (1 + rng.uniform(-.15, .15, (b, 5)))
    jstep = jsys.make_step(jlib.TANK_MIMO, 0.05)
    ref = np.asarray(jax.vmap(lambda xx, uu, t: jstep(
        xx, uu, jlib.TankMimoParams(*t)))(*(jnp.asarray(v) for v in (x, u, th))))
    out = tsys.make_step(tlib.TANK_MIMO, 0.05)(
        torch.tensor(x), torch.tensor(u),
        tlib.TankMimoParams(*torch.tensor(th).T)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    assert out.min() >= 0.0 and (out == 0.0).any()
    assert tlib.TANK_MIMO.m == 2 and tlib.get_system("tank_mimo") is tlib.TANK_MIMO
    assert tlib.TANK_MIMO.theta0 == tlib.TankMimoParams(*jlib.TANK_MIMO.theta0)
    assert tlib.TANK_MIMO.theta1 == tlib.TankMimoParams(*jlib.TANK_MIMO.theta1)


def _jax_lowrank_block(f2, p, q_block, r_block, horizon, cfg):
    """JAX's output-space block (``koopmanx/engine/core.py:644-664``), for
    one scenario, from the JAX package's own functions."""
    n_out, m = f2.shape[0], r_block.shape[0]
    rho = j_rho(p, cfg)
    d_inv = j_spd_inverse(2.0 * r_block + (cfg.sigma + rho) * jnp.eye(m))
    f2d = (f2.reshape(n_out, horizon, m) @ d_inv).reshape(n_out, horizon * m)
    s = jnp.kron(jnp.eye(horizon), j_spd_inverse(2.0 * q_block)) + f2d @ f2.T
    s_inv = j_spd_inverse(s, block=cfg.kkt_block)
    k = jnp.kron(jnp.eye(horizon), d_inv) - f2d.T @ (s_inv @ f2d)
    return 0.5 * (k + k.T)


@pytest.mark.parametrize("horizon,py,m", [(20, 1, 2), (6, 2, 3)],
                         ids=["tank_mimo", "py2-m3"])
def test_lowrank_kkt_inverse_matches_dense_and_jax(horizon, py, m):
    """Random prediction matrices at tank_mimo's shape (N*py = 20 < N*m =
    40) and at one with 2 x 2 and 3 x 3 weight blocks: the Woodbury inverse
    against the dense ``spd_inverse(box_kkt(P))`` and against JAX's block
    on the same P, 1e-10 relative to the inverse's largest entry."""
    rng = np.random.default_rng(horizon + m)
    b = 4
    f2 = 0.3 * rng.normal(size=(b, horizon * py, horizon * m))
    q_block = 10.0 * np.eye(py) + 0.5 * np.diag(rng.uniform(size=py))
    r_block = 1e-3 * np.eye(m) + 1e-4 * np.diag(rng.uniform(size=m))
    tq, tr = (torch.tensor(v).expand(b, *v.shape) for v in (q_block, r_block))
    f2_t = torch.tensor(f2)
    z0 = torch.tensor(rng.normal(size=(b, 3)))
    f1 = torch.tensor(rng.normal(size=(b, horizon * py, 3)))
    zeros = torch.zeros(b, horizon * m, dtype=F64)
    qp = condensed_qp((f1, f2_t), z0, torch.zeros(horizon * py, dtype=F64),
                      block_diag_repeat(tq, horizon),
                      block_diag_repeat(tr, horizon), zeros, zeros)
    cfg = tcore.EngineConfig(horizon=horizon, qp_kkt_block=4, qp_rho=0.1)
    out = tcore.lowrank_kkt_inverse(f2_t, qp.P, tq, tr, cfg).numpy()
    dense = spd_inverse(box_kkt(qp.P, cfg.qp_config), block=4).numpy()
    jcfg = JADMM(rho=0.1, sigma=cfg.qp_sigma, kkt_block=4)
    ref = np.stack([np.asarray(_jax_lowrank_block(
        jnp.asarray(f2[i]), jnp.asarray(qp.P[i].numpy()),
        jnp.asarray(q_block), jnp.asarray(r_block), horizon, jcfg))
        for i in range(b)])
    scale = np.abs(dense).max()
    assert np.abs(out - dense).max() <= 1e-10 * scale
    assert np.abs(out - ref).max() <= 1e-10 * scale
    np.testing.assert_array_equal(out, out.transpose(0, 2, 1))


def _configure(cfg, backend):
    """``tank_mimo`` as the bench runs it (horizon 20, N*m = 40) at test
    size: 16 steps with the switch at 8, 20x20 data, a window of 32 (16
    steps evict half of its prefilled rows), f64, on ``backend``."""
    cfg.steps = STEPS
    cfg.dtype = "float64"
    cfg.switch_step = STEPS // 2
    cfg.mpc.horizon = 20
    cfg.mpc.qp_backend = backend
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    cfg.update.window = WINDOW
    return cfg


def _arrays_from_jax(pipe):
    """The JAX pipeline as ``convert.pipeline_from_numpy`` reads it: a
    normalized RBF lift, the windowed rings, the MPC arrays."""
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    centers, mu, sc = n(pipe.dictionary.params)
    p = pipe.params
    keys = ("q_block", "r_block", "u_min", "u_max", "cy", "applied_min",
            "applied_max", "x_min", "x_max", "ref_state")
    return {
        "rbf": {"centers": centers, "kind": pipe.config.lift.rbf_type},
        "normalizer": (mu, sc),
        "model0": tuple(n(pipe.model0)),
        "rls0": {k: n(getattr(pipe.rls0, k))
                 for k in ("zx", "u", "zy", "x", "idx")},
        "params": {k: None if getattr(p, k) is None else n(getattr(p, k))
                   for k in keys},
        "x_init": n(pipe.x_init),
    }


@pytest.fixture(scope="module")
def jax_pipes():
    """One JAX pipeline a route (the same data, lift and estimator: only
    the engine config differs)."""
    return {r: j_build_pipeline(_configure(JC.tank_mimo_preset(), r))
            for r in ROUTES}


@pytest.fixture(scope="module")
def scenarios():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0.0, 2.0, size=(BATCH, 2))
    th0 = np.array(NOMINAL) * (1 + rng.uniform(-.15, .15, (BATCH, 5)))
    th1 = np.array(SWITCHED) * (1 + rng.uniform(-.15, .15, (BATCH, 5)))
    return x0, th0, th1


def _torch_pipe(jax_pipe, backend):
    cfg = _configure(TC.tank_mimo_bench_config(), backend)
    return pipeline_from_numpy(_arrays_from_jax(jax_pipe), cfg, device="cpu",
                               dtype=F64)


@pytest.mark.parametrize("backend", ROUTES)
def test_control_solve_matches_jax(jax_pipes, backend):
    """The box loop's first step (zero warm start) for 6 scenarios whose
    models are the pipeline's initial model with per-scenario noise:
    'pallas' inverts the dense 40 x 40 KKT (block 4), 'xla' builds the
    low-rank inverse (N*py = 20 < 40), each against JAX's
    ``make_control_solver`` on the same route: u and the warm start to
    1e-9, the per-channel box held."""
    jpipe = jax_pipes[backend]
    pipe = _torch_pipe(jpipe, backend)
    rng = np.random.default_rng(7)
    b, nz = 6, pipe.dictionary.nlift
    a0, b0, c0 = (np.asarray(v) for v in jpipe.model0)
    model = (a0 + 0.01 * rng.normal(size=(b, nz, nz)),
             b0 + 0.05 * rng.normal(size=(b,) + b0.shape),
             np.broadcast_to(c0, (b,) + c0.shape))
    x = rng.uniform(0.0, 2.0, size=(b, 2))
    x[0] = 0.0
    z = np.asarray(jpipe.dictionary(jnp.asarray(x)))
    warm = np.zeros((b, 40))
    ecfg = pipe.engine_cfg
    assert ecfg.qp_kkt_lowrank and ecfg.qp_backend == backend
    jsolve = jcore.make_control_solver(
        jpipe.dictionary, jpipe.engine_cfg,
        jref.constant(jnp.ones(1), 20, 1, jnp.float64), 2)
    jdec = jax.vmap(lambda mdl, zz, wx: jsolve(
        jpipe.params, mdl, (), None, zz, jnp.zeros(2), wx, (),
        jnp.asarray(0)))(JModel(*(jnp.asarray(v) for v in model)),
                         jnp.asarray(z), jnp.asarray(warm))
    tsolve = tcore.make_control_solver(
        ecfg, tref.constant(torch.ones(1, dtype=F64), 20, 1, F64), 2)
    tdec = tsolve(replicate(pipe.params, b),
                  TModel(*(torch.tensor(np.ascontiguousarray(v))
                           for v in model)),
                  torch.tensor(z), torch.zeros(b, 2, dtype=F64),
                  torch.tensor(warm), (), 0)
    u = tdec.u_applied.numpy()
    np.testing.assert_allclose(u, np.asarray(jdec.u_applied), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tdec.warm_x.numpy(), np.asarray(jdec.warm_x),
                               rtol=0, atol=1e-9)
    assert np.abs(u).max() <= 4.0 and np.abs(u).max() > 0.0


@pytest.mark.parametrize("backend", ROUTES)
def test_tank_mimo_loop_matches_jax_run_batch(jax_pipes, scenarios, backend):
    """4 scenarios x 16 steps through the switch at 8, float64, on each
    route against JAX ``run_batch`` on the same route: x to 1e-9 and u to
    1e-8 (the same f64 arithmetic up to summation order); no kernel launch
    on CPU tensors; |u| <= 4 per channel, x >= 0, both pumps used."""
    x0, th0, th1 = scenarios
    jpipe = jax_pipes[backend]
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    _, jlog = j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params),
        jnp.asarray(x0), jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        jlib.TankMimoParams(*jnp.asarray(th0.T)),
        jlib.TankMimoParams(*jnp.asarray(th1.T)))
    pipe = _torch_pipe(jpipe, backend)
    launches = box_admm.launches
    carry, log = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
        tlib.TankMimoParams(*torch.tensor(th0.T)),
        tlib.TankMimoParams(*torch.tensor(th1.T)))
    assert box_admm.launches == launches
    tx, tu = log.x.numpy(), log.u.numpy()
    assert tx.shape == (BATCH, STEPS, 2) and tu.shape == (BATCH, STEPS, 2)
    assert np.abs(tx - np.asarray(jlog.x)).max() <= 1e-9
    assert np.abs(tu - np.asarray(jlog.u)).max() <= 1e-8
    assert np.abs(tu).max() <= 4.0 and tx.min() >= 0.0
    assert (np.abs(tu).max(axis=(0, 1)) > 0.1).all()
    assert carry.rls.u.shape == (BATCH, WINDOW, 2)
    assert carry.model.B.shape == (BATCH, pipe.dictionary.nlift, 2)


def test_tank_mimo_bench_config_matches_the_bench():
    """``tank_mimo_bench_config`` is the preset with ``bench.py``'s
    overrides (f32, horizon 20, the switch at steps/2, 50x50 data with the
    preset's u_range and clamp_x0, refit every step), field for field
    against JAX's preset so overridden; it builds on the CPU, on the plant
    default x_init -2 (the JAX package starts only tank and tank3 at 0)."""
    tcfg = TC.tank_mimo_bench_config(steps=200, qp_backend="xla")
    jcfg = JC.tank_mimo_preset()
    jcfg.steps, jcfg.dtype, jcfg.switch_step = 200, "float32", 100
    jcfg.data = dataclasses.replace(jcfg.data, n_step=50, n_traj=50)
    for part in ("data", "lift", "mpc", "update"):
        t, j = dataclasses.asdict(getattr(tcfg, part)), dataclasses.asdict(
            getattr(jcfg, part))
        j = {k: v for k, v in j.items() if k in t}
        if part == "mpc":
            j["qp_backend"] = "xla"
        assert t == j, part
    assert (tcfg.steps, tcfg.switch_step, tcfg.dtype) == (200, 100, "float32")
    assert tcfg.update.window_refit_every == 1 and tcfg.data.u_range == (-4, 4)
    cfg = TC.tank_mimo_bench_config(steps=3)
    cfg.data = dataclasses.replace(cfg.data, n_step=8, n_traj=8)
    pipe = t_build_pipeline(cfg, device="cpu")
    assert pipe.x_init.tolist() == [-2.0, -2.0]
    assert pipe.params.u_max.tolist() == [4.0, 4.0]
    assert pipe.rls0.u.shape == (256, 2) and pipe.model0.B.shape == (10, 2)
