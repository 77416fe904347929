"""The closed-loop LQR controller (``controller='lqr'``) and the spectral
drift norm (``drift_norm='spectral'``) of koopmanx_torch against the JAX
package: one control solve per scenario on frozen models (output and
lifted tracking), the LQR closed loop and the spectral drift series
against JAX ``run_batch``, the serving fleet against ``run_batch``, the
option's validation, and the CLI on a RunConfig in LQR mode. float64 on
the CPU, the JAX pipeline carried across with
``convert.pipeline_from_numpy``, inputs from numpy with a seed."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine.loop import make_closed_loop as j_make_closed_loop  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.run import _ref_fn as j_ref_fn  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import cli  # noqa: E402
from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.controller import BatchedController  # noqa: E402
from koopmanx_torch.engine.loop import make_closed_loop  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import ref_fn_for, replicate  # noqa: E402
from koopmanx_torch.systems.base import make_step, make_switch_schedule  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

from test_torch_revise2 import PLANTS, configs  # noqa: E402
from test_torch_vdp import (  # noqa: E402
    BATCH,
    arrays_from_jax,
    assert_logs_match,
    run_both,
    scenarios,
)

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lqr_configs(name, steps, **mpc):
    """The preset of both packages at test size (``configs``) with
    ``controller='lqr'`` and the given MPC fields."""
    jcfg, tcfg = configs(name, steps)
    for cfg in (jcfg, tcfg):
        cfg.mpc.controller = "lqr"
        for k, v in mpc.items():
            setattr(cfg.mpc, k, v)
    return jcfg, tcfg


@pytest.mark.parametrize("name", ["duffing", "vanderpol"],
                         ids=["output", "lifted"])
def test_lqr_control_solve_matches_jax(name):
    """One LQR control solve for 6 scenarios whose models are the
    pipeline's initial model with per-scenario noise, each at its own
    state, at step 3, against JAX's ``_make_lqr_solver`` under ``vmap``:
    u within 1e-10 (relative to max(1, |u|)) in each scenario, or within
    ten times JAX's own change there when the models' A move by one ulp,
    where that is larger (the DARE of the nearly uncontrollable lifted
    VDP models amplifies round-off far past 1e-10 in u, as in the DARE
    terminal's test, tests/test_torch_revise2.py); the zero warm start
    and solution, the reference window. Output tracking pulls Q back
    through C (duffing); lifted tracking takes z_ss from the encoded
    reference (the VDP preset); the dither probe runs in both."""
    jcfg, tcfg = lqr_configs(name, 4)
    for cfg in (jcfg, tcfg):
        cfg.update.dither = 0.05
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    rng = np.random.default_rng(13)
    b, m = 6, 1
    nz = pipe.dictionary.nlift
    a0, b0, c0 = (np.asarray(v) for v in jpipe.model0)
    model = [a0 + 0.01 * rng.normal(size=(b, nz, nz)),
             b0 + 0.05 * rng.normal(size=(b,) + b0.shape),
             c0 + 0.05 * rng.normal(size=(b,) + c0.shape)]
    x = rng.uniform(-2.0, 2.0, size=(b, 2))
    z = np.asarray(jax.vmap(jpipe.dictionary)(jnp.asarray(x)))
    warm = rng.uniform(-1.0, 1.0, size=(b, tcfg.mpc.horizon * m))
    step = 3
    py = jpipe.params.q_block.shape[0]
    jsolve = jcore.make_control_solver(
        jpipe.dictionary, jpipe.engine_cfg,
        j_ref_fn(jcfg, jpipe.dictionary, py, jnp.float64), m)
    jrun = jax.jit(jax.vmap(lambda mdl, xx, zz, wx: jsolve(
        jpipe.params, mdl, (), xx, zz, jnp.zeros(m), wx, (),
        jnp.asarray(step))))
    jdec, jnudged = (jrun(JModel(jnp.asarray(a), *(jnp.asarray(v)
                                                  for v in model[1:])),
                          jnp.asarray(x), jnp.asarray(z), jnp.asarray(warm))
                     for a in (model[0], np.nextafter(model[0], 9.0)))
    tsolve = tcore.make_control_solver(
        pipe.engine_cfg, ref_fn_for(tcfg, py, "cpu", pipe.dictionary), m,
        pipe.dictionary)
    launches = box_admm.launches
    with torch.no_grad():
        tdec = tsolve(replicate(pipe.params, b),
                      TModel(*(torch.tensor(v) for v in model)),
                      torch.tensor(z), torch.zeros(b, m, dtype=F64),
                      torch.tensor(warm), (), step, (), torch.tensor(x))
    assert box_admm.launches == launches
    u, ju = tdec.u_applied.numpy(), np.asarray(jdec.u_applied)
    assert np.isfinite(u).all() and np.abs(u).max() <= tcfg.mpc.u_max
    floor = np.abs(np.asarray(jnudged.u_applied) - ju).max(-1)
    bound = np.maximum(1e-10 * np.maximum(1.0, np.abs(ju).max(-1)),
                       10.0 * floor)
    assert (np.abs(u - ju).max(-1) <= bound).all(), (u - ju, floor)
    assert not tdec.warm_x.any() and not tdec.sol.x.any()
    assert tdec.sol.y.shape == (b, 0) and tdec.cert == ()
    np.testing.assert_allclose(tdec.r_window.numpy(),
                               np.asarray(jdec.r_window)[0], rtol=0,
                               atol=1e-12)


def test_lqr_loop_matches_jax_run_batch():
    """``duffing`` with ``controller='lqr'``: 4 scenarios over 20 float64
    steps through the switch at 10, against JAX ``run_batch`` on one
    pipeline: x and u within 1e-9 in every scenario and step, or within
    ten times JAX's own divergence from one ulp of x0 there, where that
    is larger (``assert_logs_match``: the estimator's warm-up amplifies
    round-off, and one ulp of x0 moves JAX's own u by more than 1e-9
    in 20 steps); no kernel launch; |u| within the box."""
    jcfg, tcfg = lqr_configs("duffing", 20)
    jlogs, log, carry, pipe = run_both(jcfg, tcfg, PLANTS["duffing"])
    assert_logs_match(jlogs, log, x_tol=1e-9, u_tol=1e-9)
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
    assert not log.qp_primal_res.any()


def test_lqr_fleet_equals_run_batch():
    """The serving fleet in LQR mode, driven by the loop's plant, equals
    ``run_batch`` bit for bit in float64 (one shared control body), and
    both launch no kernel."""
    _, tcfg = lqr_configs("duffing", 12)
    tcfg.mpc.qp_backend = "pallas"
    from koopmanx_torch.run import build_pipeline

    pipe = build_pipeline(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    x0 = torch.tensor(rng.uniform(-2.0, 2.0, size=(BATCH, 2)))
    launches = box_admm.launches
    _, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, BATCH), x0,
                         replicate(pipe.model0, BATCH),
                         replicate(pipe.rls0, BATCH))
    fleet = BatchedController.from_pipeline(pipe, BATCH)
    system = tlib.get_system("duffing")
    plant = make_step(system, tcfg.data.h, tcfg.integrator)
    sched = make_switch_schedule(
        *(tlib.DuffingParams(*(torch.tensor(v, dtype=F64) for v in th))
          for th in (system.theta0, system.theta1)), tcfg.switch_step)
    x, us = x0, []
    for k in range(tcfg.steps):
        u = fleet.step(x)
        us.append(u)
        x = plant(x, u, sched(k))
    assert box_admm.launches == launches
    assert torch.equal(torch.stack(us, 1), log.u)


def test_lqr_refuses_the_mpc_only_options():
    """``controller='lqr'`` with the du formulation, a state box or
    terminal synthesis is a ValueError, as in the JAX package; an unknown
    controller is a ValueError; the LQR controller builds otherwise."""
    for bad in (dict(delta_u=True), dict(state_bounds=True),
                dict(terminal_synthesis=True)):
        cfg = tcore.EngineConfig(controller="lqr", **bad)
        with pytest.raises(ValueError, match="lqr"):
            tcore.make_control_solver(cfg, lambda step: None, 1)
    with pytest.raises(ValueError, match="unknown controller"):
        tcore.check_supported(tcore.EngineConfig(controller="pid"))
    tcore.make_control_solver(tcore.EngineConfig(controller="lqr"),
                              lambda step: None, 1)


def test_spectral_drift_matches_jax_run_batch():
    """``drift_norm='spectral'`` on the flagship preset: the three drift
    series (the largest singular value of each model difference) of 4
    scenarios over 16 float64 steps within 1e-10 of JAX ``run_batch``'s
    (relative to max(1, the series' largest value)), x within 1e-9; an
    unknown kind is the Frobenius norm in both packages."""
    jcfg, tcfg = configs("duffing", 16)
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    x0, th0, th1 = scenarios([-0.5, 1.0, -1.0], [-5.0, 2.0, -0.5])
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    py = jpipe.params.q_block.shape[0]
    logs = {}
    for kind in ("spectral", "nuclear"):
        jloop = j_make_closed_loop(
            jlib.DUFFING, jpipe.dictionary,
            dataclasses.replace(jpipe.engine_cfg, drift_norm=kind),
            j_ref_fn(jcfg, jpipe.dictionary, py, jnp.float64))
        jlog = jax.jit(lambda x: j_run_batch(
            jloop, jax.tree_util.tree_map(rep, jpipe.params), x,
            jax.tree_util.tree_map(rep, jpipe.model0),
            jax.tree_util.tree_map(rep, jpipe.rls0),
            jlib.DuffingParams(*jnp.asarray(th0.T)),
            jlib.DuffingParams(*jnp.asarray(th1.T)))[1])(jnp.asarray(x0))
        tloop = make_closed_loop(
            tlib.DUFFING, pipe.dictionary,
            dataclasses.replace(pipe.engine_cfg, drift_norm=kind),
            ref_fn_for(tcfg, py, "cpu", pipe.dictionary))
        _, tlog = t_run_batch(tloop, replicate(pipe.params, BATCH),
                              torch.tensor(x0), replicate(pipe.model0, BATCH),
                              replicate(pipe.rls0, BATCH),
                              tlib.DuffingParams(*torch.tensor(th0.T)),
                              tlib.DuffingParams(*torch.tensor(th1.T)))
        np.testing.assert_allclose(tlog.x.numpy(), np.asarray(jlog.x),
                                   rtol=0, atol=1e-9)
        for k in ("drift_a", "drift_b", "drift_c"):
            want = np.asarray(getattr(jlog, k))
            np.testing.assert_allclose(
                getattr(tlog, k).numpy(), want, rtol=0,
                atol=1e-10 * max(1.0, np.abs(want).max()), err_msg=k)
        logs[kind] = tlog
    # the spectral norm is at most the Frobenius one, and differs from it
    spec, fro = logs["spectral"].drift_a, logs["nuclear"].drift_a
    assert (spec <= fro * (1 + 1e-12)).all() and (spec < fro).any()


def test_cli_runs_an_lqr_config_file(capsys, tmp_path):
    """``python -m koopmanx_torch.cli run --config`` on a RunConfig JSON
    whose ``mpc.controller`` is 'lqr' completes on the CPU: a finite
    summary with |u| within the box."""
    cfg = TC.duffing_nn_preset()
    cfg.steps = 30
    cfg.data = TC.DataConfig(n_step=20, n_traj=20)
    cfg.mpc.controller = "lqr"
    path = tmp_path / "lqr.json"
    path.write_text(cfg.to_json())
    cli.main(["run", "--cpu", "--config", str(path)])
    summary = json.loads(capsys.readouterr().out)
    assert summary["steps"] == 30
    assert summary["u_abs_max"] <= cfg.mpc.u_max
    assert np.isfinite(summary["final_state"]).all()


@pytest.mark.parametrize("mode", ["lqr", "lmi"])
def test_controller_state_from_a_jax_controller(mode):
    """A JAX Controller's state after 6 calls, in LQR mode (no
    certificate) or on ``revise2_duffing`` with ``terminal_mode='lmi'``
    (its held (P, K, gamma) from the LMI), carried across with
    ``convert.controller_state_from_numpy`` and back through
    ``controller_state_to_numpy`` unchanged; the port's Controller from
    that state, fed JAX's measurements, gives JAX's inputs over the
    remaining 6 calls to 1e-9."""
    from koopmanx_torch.convert import (
        controller_state_from_numpy,
        controller_state_to_numpy,
    )
    from koopmanx_torch.engine.controller import Controller
    from koopmanx_torch.tree import tree_leaves

    from test_torch_controller import _drive_jax

    if mode == "lqr":
        jcfg, tcfg = lqr_configs("duffing", 12)
    else:
        jcfg, tcfg = configs("revise2_duffing", 12)
        for cfg in (jcfg, tcfg):
            cfg.mpc.terminal_mode = "lmi"
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    keep = 6
    jxs, jus, kept = _drive_jax(jpipe, 12, keep_state_at=keep)
    arrays = {
        "model": tuple(kept.model), "rls": kept.rls._asdict(),
        "u_prev": kept.u_prev, "warm_x": kept.warm_x, "warm_y": kept.warm_y,
        "z_prev": kept.z_prev, "x_prev": kept.x_prev,
        "have_prev": kept.have_prev, "res_ema": kept.res_ema,
        "cert": kept.cert or None,
    }
    state = controller_state_from_numpy(arrays, tcfg, device="cpu",
                                        dtype=F64)
    assert len(state.cert) == (0 if mode == "lqr" else 3)
    back = controller_state_from_numpy(controller_state_to_numpy(state),
                                       tcfg, device="cpu", dtype=F64)
    for u, v in zip(tree_leaves(state), tree_leaves(back), strict=True):
        assert torch.equal(u, v)
    ctrl = Controller.from_pipeline(pipe)
    ctrl.state, ctrl._k = state, np.array([keep])
    us = [ctrl.step(torch.tensor(x)).numpy() for x in jxs[keep:]]
    np.testing.assert_allclose(np.stack(us), jus[keep:], rtol=0, atol=1e-9)
