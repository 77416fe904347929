"""The general-inequality QP path of koopmanx_torch's engine against the
JAX package: ``condensed_qp`` with extra rows, ``solve_qp`` with rows
shared by every scenario, the control solve with the applied window as
explicit rows (``applied_bounds='rows'``) and with the state box through
F1/F2 (``state_bounds``), ``dual_dim`` and the 'full' dual warm start,
and the tank loop with rows and a Duffing loop with a state box against
JAX ``run_batch``. float64 on the CPU; inputs from numpy with a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control.condensed import condensed_qp as j_condensed_qp  # noqa: E402
from koopmanx.control.qp import ADMMConfig as JADMM  # noqa: E402
from koopmanx.control.qp import solve_qp as j_solve_qp  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine import ref as jref  # noqa: E402
from koopmanx.engine.loop import make_closed_loop as j_make_closed_loop  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.run import _ref_fn as j_ref_fn  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402
from koopmanx.types import QPData as JQP  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control.condensed import condensed_qp  # noqa: E402
from koopmanx_torch.control.qp import ADMMConfig, solve_qp  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine import ref as tref  # noqa: E402
from koopmanx_torch.engine.loop import make_closed_loop  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import ref_fn_for, replicate  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402
from koopmanx_torch.types import QPData  # noqa: E402

F64 = torch.float64
BATCH = 4
PARAM_KEYS = ("q_block", "r_block", "u_min", "u_max", "cy", "applied_min",
              "applied_max", "x_min", "x_max", "ref_state")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
def test_condensed_qp_with_rows_matches_jax(shared):
    """Extra rows shared by every scenario (the applied-window selector)
    or per scenario (F2's state rows): P, q, A (identity rows first), l
    and u against JAX's ``condensed_qp``, 1e-12."""
    rng = np.random.default_rng(3)
    b, horizon, py, m, nz, nc = 3, 5, 1, 2, 4, 6
    f1 = rng.normal(size=(b, horizon * py, nz))
    f2 = rng.normal(size=(b, horizon * py, horizon * m))
    z0, yr = rng.normal(size=(b, nz)), rng.normal(size=horizon * py)
    qbar = np.kron(np.eye(horizon), 10.0 * np.eye(py))
    rbar = np.kron(np.eye(horizon), 1e-3 * np.eye(m))
    lo, hi = -rng.uniform(1, 2, (b, horizon * m)), rng.uniform(1, 2, (b, horizon * m))
    a_ineq = rng.normal(size=(nc, horizon * m) if shared
                        else (b, nc, horizon * m))
    l_ineq, u_ineq = -rng.uniform(size=(b, nc)), rng.uniform(size=(b, nc))
    ref = jax.vmap(lambda f1_, f2_, z_, lo_, hi_, a_, l_, u_: j_condensed_qp(
        (f1_, f2_), z_, jnp.asarray(yr), jnp.asarray(qbar), jnp.asarray(rbar),
        lo_, hi_, a_, l_, u_), in_axes=(0, 0, 0, 0, 0, None if shared else 0,
                                        0, 0))(
        *(jnp.asarray(v) for v in (f1, f2, z0, lo, hi, a_ineq, l_ineq, u_ineq)))
    t = lambda v: torch.tensor(v)
    out = condensed_qp((t(f1), t(f2)), t(z0), t(yr), t(qbar), t(rbar), t(lo),
                       t(hi), t(a_ineq), t(l_ineq), t(u_ineq))
    assert isinstance(out, QPData)
    assert tuple(out.A.shape) == ((horizon * m + nc, horizon * m) if shared
                                  else (b, horizon * m + nc, horizon * m))
    for o, r in zip(out, ref):
        o = o.expand(r.shape).numpy()
        np.testing.assert_allclose(o, np.asarray(r), rtol=0, atol=1e-12)


def test_solve_qp_with_shared_rows_matches_jax():
    """One A for every scenario (no batch axis) against JAX's ``solve_qp``
    per scenario, 60 iterations from a warm primal and dual: x, z and y to
    1e-10."""
    rng = np.random.default_rng(5)
    b, nx, nc = 6, 8, 10
    mm = rng.normal(size=(b, nx, nx))
    p = mm @ mm.transpose(0, 2, 1) + np.eye(nx)
    q = rng.normal(size=(b, nx))
    a = np.concatenate([np.eye(nx), rng.normal(size=(nc - nx, nx))])
    lo, hi = -rng.uniform(0.2, 1, (b, nc)), rng.uniform(0.2, 1, (b, nc))
    x0, y0 = 0.1 * rng.normal(size=(b, nx)), 0.1 * rng.normal(size=(b, nc))
    cfg = ADMMConfig(iters=60, rho=0.1, kkt_block=4)
    jcfg = JADMM(iters=60, rho=0.1, kkt_block=4)
    ref = jax.vmap(lambda p_, q_, l_, u_, x_, y_: j_solve_qp(
        JQP(p_, q_, jnp.asarray(a), l_, u_), jcfg, x_, y_))(
        *(jnp.asarray(v) for v in (p, q, lo, hi, x0, y0)))
    t = lambda v: torch.tensor(v)
    out = solve_qp(QPData(t(p), t(q), t(a), t(lo), t(hi)), cfg, t(x0), t(y0))
    for name in ("x", "z", "y", "primal_res", "dual_res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-10)


def _du_pipe():
    """The tank_mimo du variant of tests/test_engine.py:447-501 (JAX),
    whose dictionary and initial model feed one control solve."""
    cfg = JC.tank_mimo_preset()
    cfg.dtype, cfg.steps = "float64", 2
    cfg.data = JC.DataConfig(n_step=30, n_traj=30, u_range=(-5.0, 5.0),
                             clamp_x0=True)
    return j_build_pipeline(cfg)


@pytest.fixture(scope="module")
def du_pipe():
    return _du_pipe()


@pytest.mark.parametrize("rows,state,warm", [
    ("rows", False, "primal"), ("box", True, "primal"),
    ("rows", True, "full")], ids=["rows", "state_bounds", "both-full"])
def test_general_control_solve_matches_jax(du_pipe, rows, state, warm):
    """One du control solve on tank_mimo (m = 2, horizon 12) for 5
    scenarios, per-channel du box and applied window (u_prev inside, at
    and near its edges), with the window as explicit rows, with a state
    box on the tracked level through F1/F2 (active: the levels sit near
    it), or both with the 'full' warm start (a dual of dual_dim rows): u
    against JAX's ``make_control_solver`` to 1e-9, the warm start to 1e-8
    and the dual to 1e-9 of its largest entry; the applied window and the
    du box hold on u."""
    rng = np.random.default_rng(17)
    b, m, horizon = 5, 2, 12
    d = du_pipe.dictionary
    kw = dict(horizon=horizon, steps=10, delta_u=True, update="off",
              switch_step=10**9, qp_rho=0.1, applied_bounds=rows,
              state_bounds=state, qp_warm_start=warm)
    params = dict(q_block=10.0 * np.eye(1), r_block=1e-3 * np.eye(2),
                  u_min=[-0.5, -0.4], u_max=[0.5, 0.4],
                  cy=np.array([[0.0, 1.0]]),
                  applied_min=[-4.0, -3.0], applied_max=[4.0, 3.0])
    if state:
        params.update(x_min=np.full(horizon, 0.2), x_max=np.full(horizon, 0.9))
    x = rng.uniform(0.3, 1.2, size=(b, 2))
    z = np.asarray(d(jnp.asarray(x)))
    u_prev = np.array([[0.9, -0.3], [3.8, 2.9], [-4.0, -3.0], [0.0, 3.0],
                       [-3.7, 0.2]])
    nc = (horizon * m + (m if rows == "rows" else 0)
          + (horizon if state else 0))
    warm_x = 0.1 * rng.normal(size=(b, horizon * m))
    warm_y = 0.1 * rng.normal(size=(b, nc)) if warm == "full" else ()
    a0, b0, c0 = (np.asarray(v) for v in du_pipe.model0)
    # small per-scenario noise: at 1e-2 some lifted models turn unstable
    # over the horizon and the 60-iteration ADMM is far from converged
    model = (a0 + 1e-3 * rng.normal(size=(b,) + a0.shape),
             np.broadcast_to(b0, (b,) + b0.shape),
             np.broadcast_to(c0, (b,) + c0.shape))
    ref_j = jref.constant(jnp.ones(1), horizon, 1, jnp.float64)
    jcfg = jcore.EngineConfig(**kw)
    jp = jcore.MPCParams(**{k: jnp.asarray(v, jnp.float64)
                            for k, v in params.items()})
    assert jcore.dual_dim(jcfg, jp, m) == nc
    jsolve = jcore.make_control_solver(d, jcfg, ref_j, m)
    jdec = jax.vmap(lambda mdl, zz, up, wx, wy: jsolve(
        jp, mdl, (), None, zz, up, wx, wy, jnp.asarray(5)),
        in_axes=(0, 0, 0, 0, 0 if warm == "full" else None))(
        JModel(*(jnp.asarray(v) for v in model)), jnp.asarray(z),
        jnp.asarray(u_prev), jnp.asarray(warm_x),
        jnp.asarray(warm_y) if warm == "full" else ())
    tcfg = tcore.EngineConfig(**kw)
    tp = tcore.MPCParams(**{k: torch.tensor(np.asarray(v, float))
                            for k, v in params.items()})
    assert tcore.dual_dim(tcfg, tp, m) == nc
    tsolve = tcore.make_control_solver(
        tcfg, tref.constant(torch.ones(1, dtype=F64), horizon, 1, F64), m)
    tdec = tsolve(replicate(tp, b),
                  TModel(*(torch.tensor(np.ascontiguousarray(v))
                           for v in model)),
                  torch.tensor(z), torch.tensor(u_prev), torch.tensor(warm_x),
                  torch.tensor(warm_y) if warm == "full" else (), 5)
    u = tdec.u_applied.numpy()
    np.testing.assert_allclose(u, np.asarray(jdec.u_applied), rtol=0, atol=1e-9)
    assert tuple(tdec.sol.y.shape) == (b, nc)
    # the warm start's late moves are weakly determined: 60 iterations
    # carry summation-order differences there to ~3e-9 (its first moves,
    # u, agree to ~1e-13); the dual reaches ~300 where the state box binds
    np.testing.assert_allclose(tdec.warm_x.numpy(), np.asarray(jdec.warm_x),
                               rtol=0, atol=1e-8)
    jy = np.asarray(jdec.sol.y)
    assert np.abs(tdec.sol.y.numpy() - jy).max() <= 1e-9 * np.abs(jy).max()
    assert (u >= np.array(params["applied_min"]) - 1e-12).all()
    assert (u <= np.array(params["applied_max"]) + 1e-12).all()
    assert (np.abs(u - u_prev) <= np.array(params["u_max"]) + 1e-12).all()


def _arrays_from_jax(pipe, lift):
    """The JAX pipeline as ``convert.pipeline_from_numpy`` reads it: a
    normalized RBF lift and the windowed rings (``lift='rbf'``), or an
    un-normalized MLP and the square-root RLS state (``'mlp'``)."""
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    p = pipe.params
    out = {"model0": tuple(n(pipe.model0)),
           "params": {k: None if getattr(p, k) is None else n(getattr(p, k))
                      for k in PARAM_KEYS},
           "x_init": n(pipe.x_init)}
    if lift == "rbf":
        centers, mu, sc = n(pipe.dictionary.params)
        out.update(rbf={"centers": centers, "kind": "thinplate"},
                   normalizer=(mu, sc),
                   rls0={k: n(getattr(pipe.rls0, k))
                         for k in ("zx", "u", "zy", "x", "idx")})
    else:
        out.update(mlp=[tuple(layer) for layer in n(pipe.dictionary.params)],
                   normalizer=None, rls0=n(pipe.rls0._asdict()))
    return out


def _tank_rows(cfg, steps=20):
    """The tank preset at test size with the applied window as rows: 20
    steps, the switch at 10, window 32, 20x20 data, f64, the kernel route
    (the rows send every step to the general ADMM, so no kernel runs)."""
    cfg.steps, cfg.dtype, cfg.switch_step = steps, "float64", steps // 2
    cfg.mpc.qp_backend = "pallas"
    cfg.mpc.applied_bounds = "rows"
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    cfg.update.window = 32
    return cfg


def _duffing_state(cfg, lift_cls, data_cls, steps=20):
    """The flagship recipe at test size (horizon 10, an MLP 2-16-16-16-8,
    20x20 data, f64, the switch at 10) with the state box |x_i| <= 1.05
    over the horizon: N*py = 20 state rows."""
    cfg.steps, cfg.dtype, cfg.switch_step = steps, "float64", steps // 2
    cfg.mpc.horizon = 10
    cfg.mpc.qp_backend = "pallas"
    cfg.mpc.state_bounds = (-1.05, 1.05)
    cfg.data = data_cls(n_step=20, n_traj=20)
    cfg.lift = lift_cls(kind="mlp", nlift=8, hidden=16)
    return cfg


CASES = {
    "tank-rows": (lambda: _tank_rows(JC.tank_preset()),
                  lambda: _tank_rows(TC.tank_preset()), "rbf", jlib.TankParams,
                  tlib.TankParams, ([0.5, 0.4, 0.2, 0.3],
                                    [0.53, 0.3, 0.1, 0.35]), (0.0, 2.0)),
    "duffing-state": (lambda: _duffing_state(JC.duffing_nn_preset(),
                                             JC.LiftConfig, JC.DataConfig),
                      lambda: _duffing_state(TC.duffing_nn_preset(),
                                             TC.LiftConfig, TC.DataConfig),
                      "mlp", jlib.DuffingParams, tlib.DuffingParams,
                      ([-0.5, 1.0, -1.0], [-5.0, 2.0, -0.5]), (-2.0, 2.0)),
}


@pytest.fixture(scope="module")
def jax_pipes():
    return {}


def _jax_pipe(jax_pipes, case):
    if case not in jax_pipes:
        jax_pipes[case] = j_build_pipeline(CASES[case][0]())
    return jax_pipes[case]


@pytest.mark.parametrize("case,warm", [("tank-rows", "primal"),
                                       ("tank-rows", "full"),
                                       ("duffing-state", "primal")])
def test_loop_with_rows_matches_jax_run_batch(jax_pipes, case, warm):
    """4 scenarios x 20 steps through the switch at 10, float64, against
    JAX ``run_batch`` on the same pipeline and engine config: the tank loop
    with the applied window as rows (the preset's primal warm start, and
    the 'full' one, whose dual carries dual_dim = N*m + m rows), and a
    Duffing loop with the state box |x| <= 1.05 (N*py = 20 rows). x and u
    to 1e-9 (the same f64 arithmetic up to summation order); no kernel
    launch; the bounds of each case hold on u."""
    _, tcfg_fn, lift, jparams, tparams, (th_nom, th_sw), x0r = CASES[case]
    jpipe = _jax_pipe(jax_pipes, case)
    rng = np.random.default_rng(1)
    k = len(th_nom)
    x0 = rng.uniform(*x0r, size=(BATCH, 2))
    th0 = np.array(th_nom) * (1 + rng.uniform(-.15, .15, (BATCH, k)))
    th1 = np.array(th_sw) * (1 + rng.uniform(-.15, .15, (BATCH, k)))
    jcfg = dataclasses.replace(jpipe.engine_cfg, qp_warm_start=warm)
    jloop = j_make_closed_loop(
        jlib.get_system(jpipe.config.system), jpipe.dictionary, jcfg,
        j_ref_fn(jpipe.config, jpipe.dictionary,
                 jpipe.params.q_block.shape[0], jnp.float64))
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    _, jlog = j_run_batch(
        jloop, jax.tree_util.tree_map(rep, jpipe.params), jnp.asarray(x0),
        jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        jparams(*jnp.asarray(th0.T)), jparams(*jnp.asarray(th1.T)))
    pipe = pipeline_from_numpy(_arrays_from_jax(jpipe, lift), tcfg_fn(),
                               device="cpu", dtype=F64)
    tcfg = dataclasses.replace(pipe.engine_cfg, qp_warm_start=warm)
    assert tcfg.applied_bounds == jcfg.applied_bounds
    assert tcfg.state_bounds == jcfg.state_bounds
    tloop = make_closed_loop(tlib.get_system(pipe.config.system),
                             pipe.dictionary, tcfg, _ref_fn_of(pipe))
    launches = box_admm.launches
    carry, log = t_run_batch(
        tloop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
        tparams(*torch.tensor(th0.T)), tparams(*torch.tensor(th1.T)))
    assert box_admm.launches == launches
    tx, tu = log.x.numpy(), log.u.numpy()
    assert np.abs(tx - np.asarray(jlog.x)).max() <= 1e-9
    assert np.abs(tu - np.asarray(jlog.u)).max() <= 1e-9
    nc = tcore.dual_dim(tcfg, pipe.params, 1)
    assert nc == jcore.dual_dim(jcfg, jpipe.params, 1)
    if warm == "full":
        assert tuple(carry.warm_y.shape) == (BATCH, nc) == (BATCH, 21)
    if case == "tank-rows":
        u = np.concatenate([np.zeros((BATCH, 1)), tu[..., 0]], axis=1)
        assert np.abs(np.diff(u, axis=1)).max() <= 0.5 + 1e-12
        assert np.abs(tu).max() <= 8.0 and tx.min() >= 0.0
    else:
        assert nc == 10 + 20 and np.abs(tu).max() <= 2.0


def _ref_fn_of(pipe):
    return ref_fn_for(pipe.config, pipe.params.q_block.shape[0], pipe.device)


@pytest.mark.parametrize("applied,state,expected", [
    ("box", None, 40), ("rows", None, 42), ("box", (0.0, 2.0), 60),
    ("rows", (0.0, 2.0), 62)])
def test_dual_dim_sizes_the_full_warm_start(applied, state, expected):
    """``dual_dim`` on the tank_mimo du variant (N = 20, m = 2, py = 1):
    N*m box rows, m more for the applied window as rows, N*py more for
    the state box; the port's and JAX's agree, and the loop's 'full' dual
    warm start starts at and keeps that size."""
    cfg = TC.tank_mimo_bench_config(steps=2)
    mc = cfg.mpc
    mc.delta_u, mc.applied_min, mc.applied_max = True, -4.0, 4.0
    mc.applied_bounds, mc.state_bounds = applied, state
    cfg.data = dataclasses.replace(cfg.data, n_step=8, n_traj=8)
    pipe = t_build_pipeline(cfg, device="cpu")
    ecfg = dataclasses.replace(pipe.engine_cfg, qp_warm_start="full")
    assert tcore.dual_dim(ecfg, pipe.params, 2) == expected
    jp = jcore.MPCParams(**{k: None if getattr(pipe.params, k) is None
                            else jnp.asarray(getattr(pipe.params, k).numpy())
                            for k in PARAM_KEYS})
    jcfg = jcore.EngineConfig(horizon=20, delta_u=True, applied_bounds=applied,
                              state_bounds=state is not None)
    assert jcore.dual_dim(jcfg, jp, 2) == expected
    loop = make_closed_loop(tlib.TANK_MIMO, pipe.dictionary, ecfg,
                            _ref_fn_of(pipe))
    x0 = torch.tensor(np.random.default_rng(2).uniform(0, 2, (3, 2)),
                      dtype=torch.float32)
    carry, log = t_run_batch(loop, replicate(pipe.params, 3), x0,
                             replicate(pipe.model0, 3), replicate(pipe.rls0, 3))
    assert tuple(carry.warm_y.shape) == (3, expected)
    assert torch.isfinite(log.u).all() and float(log.u.abs().max()) <= 4.0
