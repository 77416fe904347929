"""The serving API of koopmanx_torch (``engine/controller.py``): the port's
Controller against the JAX Controller on the same pipeline, Controller
against the port's own ``run_single`` in every update mode, the fleet
against single controllers, the masked reset and its per-plant episode
clocks, the per-plant schedules of the engine, and checkpoints of the
controller state. float64 on the CPU."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine.controller import Controller as JController  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import get_system as j_get_system  # noqa: E402
from koopmanx.systems import make_step as j_make_step  # noqa: E402
from koopmanx.systems import make_switch_schedule as j_switch  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import (  # noqa: E402
    controller_state_from_numpy,
    controller_state_to_numpy,
    pipeline_from_numpy,
)
from koopmanx_torch.edmd.windowed import window_init, window_prefill  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.controller import (  # noqa: E402
    BatchedController,
    Controller,
)
from koopmanx_torch.eval.persist import load_pytree, save_pytree  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_pipeline, ref_fn_for, run_single  # noqa: E402
from koopmanx_torch.systems.base import (  # noqa: E402
    as_params,
    make_step,
    make_switch_schedule,
)
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.tree import tree_leaves, tree_map  # noqa: E402
from koopmanx_torch.types import LinearModel  # noqa: E402

from test_torch_vdp import F64, arrays_from_jax  # noqa: E402

STEPS = 50


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _small(C, preset="duffing", switch_step=10**9, **update):
    """A preset at test size in float64 (``tests/test_controller_equiv.py``'s
    ``_small_duffing``): 40 x 40 data, the switch moved out of the run
    unless given; ``update`` replaces the estimator's config."""
    cfg = C.PRESETS[preset]()
    cfg.steps = STEPS
    cfg.dtype = "float64"
    cfg.switch_step = switch_step
    cfg.data = C.DataConfig(n_step=40, n_traj=40)
    if preset == "tank":
        cfg.data = C.DataConfig(n_step=40, n_traj=40, u_range=(-5.0, 5.0),
                                clamp_x0=True)
    if update:
        cfg.update = C.UpdateConfig(**update)
    return cfg


def _drive(pipe, steps=STEPS):
    """The port's Controller against the pipeline's plant stepped outside
    it (same integrator, same switch schedule); returns (x, u) stacked."""
    ecfg = pipe.engine_cfg
    system = get_system(pipe.config.system)
    plant = make_step(system, ecfg.h, ecfg.integrator)
    kw = dict(dtype=pipe.x_init.dtype, device=pipe.device)
    sched = make_switch_schedule(as_params(system.theta0, **kw),
                                 as_params(system.theta1, **kw),
                                 ecfg.switch_step)
    ctrl = Controller.from_pipeline(pipe)
    x, xs, us = pipe.x_init, [], []
    for k in range(steps):
        xs.append(x)
        u = ctrl.step(x)
        us.append(u)
        x = plant(x[None], u[None], sched(k))[0]
    return torch.stack(xs).numpy(), torch.stack(us).numpy()


def _drive_jax(jpipe, steps, keep_state_at=None):
    """The JAX Controller against the JAX plant; returns (x, u) and the
    controller's state (as numpy) before call ``keep_state_at``."""
    ecfg = jpipe.engine_cfg
    system = j_get_system(jpipe.config.system)
    plant = j_make_step(system, ecfg.h, ecfg.integrator)
    dtype = jpipe.x_init.dtype
    as_dt = lambda t: jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), t)
    sched = j_switch(as_dt(system.theta0), as_dt(system.theta1),
                     ecfg.switch_step)
    ctrl = JController.from_pipeline(jpipe)
    x, xs, us, kept = jpipe.x_init, [], [], None
    for k in range(steps):
        if k == keep_state_at:
            kept = jax.tree_util.tree_map(np.asarray, ctrl.state)
        xs.append(np.asarray(x))
        u = ctrl.step(x)
        us.append(np.asarray(u))
        x = plant(x, u, sched(jnp.asarray(k)))
    return np.stack(xs), np.stack(us), kept


# the JAX cases, at most three (each compiles a JAX controller): the
# dither and the plant switch on the square-root RLS; the tank's du
# formulation with its windowed estimator on a refit cadence and the late
# chain; the per-step terminal synthesis with its certificate guard. (The
# Woodbury lane with its anchor under a sine reference stays 1.45e-8 apart
# in u over 30 steps, where its loop's one-ulp floor lies:
# tests/test_torch_rbf128.py holds that lane's loop to u 1e-8.)
JAX_CASES = {
    "duffing_dither_switch": dict(
        preset="duffing", switch_step=15,
        update=dict(mode="rls_sqrt", ridge=1e-6, dither=0.02)),
    "tank_cadence": dict(
        preset="tank",
        update=dict(mode="windowed", window=32, window_refit_every=3,
                    window_filter_late=12, window_filter_warmup=10,
                    c_pairing="same")),
    "revise2_duffing": dict(preset="revise2_duffing"),
}
JAX_STEPS, KEEP_AT = 30, 12


def _case_cfg(C, case):
    spec = JAX_CASES[case]
    return _small(C, spec["preset"], spec.get("switch_step", 10**9),
                  **spec.get("update", {}))


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    jpipe = j_build_pipeline(_case_cfg(JC, case))
    xs, us, kept = _drive_jax(jpipe, JAX_STEPS, keep_state_at=KEEP_AT)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), _case_cfg(TC, case),
                               device="cpu", dtype=F64)
    return pipe, xs, us, kept


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_controller_matches_jax_controller(case):
    """The port's Controller on the JAX pipeline carried across, driven by
    its own plant, against the JAX Controller driven by JAX's: x and u to
    1e-9 over 30 steps (the loop's tolerance, tests/test_torch_loop.py)."""
    pipe, jxs, jus, _ = _jax_case(case)
    launches = box_admm.launches
    xs, us = _drive(pipe, JAX_STEPS)
    assert box_admm.launches == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(us, jus, rtol=0, atol=1e-9)


def test_controller_resumes_from_a_jax_state():
    """The JAX controller's state after 12 calls, carried across with
    ``convert.controller_state_from_numpy`` (a single controller's arrays
    gain a plant axis of one), goes on to JAX's inputs: u to 1e-9 over
    the remaining 18 calls, fed JAX's measurements; the state survives
    ``controller_state_to_numpy`` and back unchanged."""
    case = "duffing_dither_switch"
    pipe, jxs, jus, kept = _jax_case(case)
    arrays = {
        "model": tuple(kept.model), "rls": kept.rls._asdict(),
        "u_prev": kept.u_prev, "warm_x": kept.warm_x, "warm_y": kept.warm_y,
        "z_prev": kept.z_prev, "x_prev": kept.x_prev,
        "have_prev": kept.have_prev, "res_ema": kept.res_ema,
        "cert": kept.cert or None,
    }
    cfg = _case_cfg(TC, case)
    state = controller_state_from_numpy(arrays, cfg, device="cpu", dtype=F64)
    assert state.u_prev.shape == (1, 1) and state.have_prev.shape == (1,)
    back = controller_state_from_numpy(controller_state_to_numpy(state), cfg,
                                       device="cpu", dtype=F64)
    for u, v in zip(tree_leaves(state), tree_leaves(back), strict=True):
        assert torch.equal(u, v)
    ctrl = Controller.from_pipeline(pipe)
    ctrl.state, ctrl._k = state, np.array([KEEP_AT])
    us = [ctrl.step(torch.tensor(x)).numpy() for x in jxs[KEEP_AT:]]
    np.testing.assert_allclose(np.stack(us), jus[KEEP_AT:], rtol=0, atol=1e-9)


# tests/test_controller_equiv.py:78-157's parametrization, each case's
# tolerance the JAX test's, as a ceiling: the port's Controller and its
# loop run the same eager operations in the same order
EQUIV_CASES = {
    "rls": (dict(update=dict(mode="rls")), 1e-6),
    "rls_sqrt_dither": (dict(update=dict(mode="rls_sqrt", ridge=1e-6,
                                         dither=0.02)), 1e-6),
    "rls_chol_reset": (dict(update=dict(mode="rls_chol", reset_mult=4.0)),
                       1e-4),
    "windowed": (dict(update=dict(mode="windowed", window=32)), 1e-6),
    "windowed_cadence_late": (dict(update=dict(
        mode="windowed", window=32, window_refit_every=3,
        window_filter_late=12, window_filter_warmup=10)), 1e-6),
    "storage": (dict(update=dict(mode="storage")), 1e-6),
    "off": (dict(update=dict(mode="off")), 1e-6),
    "woodbury_anchor": (dict(update=dict(
        mode="windowed", window=32, window_carry="woodbury",
        window_anchor=16, ridge=1e-2)), 1e-6),
    "plant_switch": (dict(switch_step=20), 1e-6),
    "tank_delta_u": (dict(preset="tank"), 1e-6),
    "terminal_synthesis": (dict(preset="revise2_duffing"), 1e-6),
    "state_bounds": (dict(state_bounds=(-3.0, 3.0)), 1e-6),
}


@pytest.mark.parametrize("case", sorted(EQUIV_CASES))
def test_controller_matches_run_single(case):
    """Controller.step against the loop (``run_single``) over 50 steps,
    every update mode and engine feature of the JAX test; observed:
    equal bit for bit."""
    spec, tol = EQUIV_CASES[case]
    spec = dict(spec)
    bounds = spec.pop("state_bounds", None)
    cfg = _small(TC, spec.get("preset", "duffing"),
                 spec.get("switch_step", 10**9), **spec.get("update", {}))
    if bounds is not None:
        cfg.mpc.state_bounds = bounds
    pipe = build_pipeline(cfg, device="cpu")
    _, log = run_single(pipe)
    xs, us = _drive(pipe)
    np.testing.assert_allclose(xs, log.x.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(us, log.u.numpy(), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def duffing_pipe():
    return build_pipeline(_small(TC), device="cpu")


def _ref_fn(pipe):
    return ref_fn_for(pipe.config, pipe.params.q_block.shape[-1], pipe.device,
                      pipe.dictionary)


def _plant(pipe):
    system = get_system(pipe.config.system)
    step = make_step(system, pipe.engine_cfg.h, pipe.engine_cfg.integrator)
    th = as_params(system.theta0, F64, pipe.device)
    return lambda x, u: step(x, u, th)


def test_batched_controller_matches_single_controllers(duffing_pipe):
    """Three plants from distinct initial states: the fleet's inputs equal
    three Controllers' to 1e-9 (the JAX test's) over 10 calls."""
    pipe = duffing_pipe
    plant = _plant(pipe)
    bc = BatchedController.from_pipeline(pipe, 3)
    singles = [Controller.from_pipeline(pipe) for _ in range(3)]
    x = torch.stack([pipe.x_init, pipe.x_init + 0.1, pipe.x_init - 0.2])
    for _ in range(10):
        u = bc.step(x)
        us = torch.stack([s.step(x[i]) for i, s in enumerate(singles)])
        np.testing.assert_allclose(u.numpy(), us.numpy(), rtol=0, atol=1e-9)
        x = plant(x, u)


def test_batched_controller_heterogeneous_params_and_models(duffing_pipe):
    """``batch_params``: input weights scaled 1, 1e7, 1e9 per plant give
    strictly smaller first moves, as in the JAX test; ``batch_model``:
    per-plant starting models. Each plant's inputs equal a Controller's
    built on that plant's params and model, to 1e-9, over 8 calls."""
    pipe = duffing_pipe
    plant = _plant(pipe)
    ref_fn = _ref_fn(pipe)
    scales = torch.tensor([1.0, 1e7, 1e9], dtype=F64)
    params = tree_map(lambda a: a.expand((3,) + a.shape).clone(), pipe.params)
    params = params._replace(r_block=params.r_block * scales[:, None, None])
    nudge = torch.tensor([1.0, 0.99, 1.01], dtype=F64)[:, None, None]
    model0 = tree_map(lambda a: a.expand((3,) + a.shape).clone(), pipe.model0)
    model0 = model0._replace(A=model0.A * nudge)
    rls0 = tree_map(lambda a: a.expand((3,) + a.shape).clone(), pipe.rls0)
    bc = BatchedController(pipe.dictionary, pipe.engine_cfg, params, ref_fn,
                           model0, rls0, batch=3, batch_params=True,
                           batch_model=True, device="cpu")
    take = lambda tree, i: tree_map(lambda a: a[i], tree)
    singles = [Controller(pipe.dictionary, pipe.engine_cfg, take(params, i),
                          ref_fn, take(model0, i), take(rls0, i),
                          device="cpu") for i in range(3)]
    x = pipe.x_init.expand(3, -1)
    first = bc.step(x)
    u_abs = first[:, 0].abs()
    assert u_abs[0] > u_abs[1] > u_abs[2], u_abs
    us = torch.stack([s.step(x[i]) for i, s in enumerate(singles)])
    np.testing.assert_allclose(first.numpy(), us.numpy(), rtol=0, atol=1e-9)
    x = plant(x, first)
    for _ in range(7):
        u = bc.step(x)
        us = torch.stack([s.step(x[i]) for i, s in enumerate(singles)])
        np.testing.assert_allclose(u.numpy(), us.numpy(), rtol=0, atol=1e-9)
        x = plant(x, u)


def test_batched_controller_reset_masked(duffing_pipe):
    """tests/test_controller.py:140-196 on the port: a masked reset
    restarts the selected plants' clocks and transient state and keeps
    their adapted model; the rest are untouched; ``full=True`` restores
    the starting model for the selected plants only; a wrong mask shape
    raises; the fleet keeps running."""
    pipe = duffing_pipe
    plant = _plant(pipe)
    bc = BatchedController.from_pipeline(pipe, 3)
    x = torch.tensor([[-1.5, 1.0], [0.5, -0.5], [1.0, 1.0]], dtype=F64)
    for _ in range(6):
        x = plant(x, bc.step(x))
    model_pre = bc.state.model.A.clone()
    warm_pre = bc.state.warm_x.clone()
    assert warm_pre[1].abs().max() > 0

    bc.reset(mask=torch.tensor([True, False, False]))
    np.testing.assert_array_equal(bc.clocks, [0, 6, 6])
    assert bc.state.have_prev.tolist() == [False, True, True]
    assert bc.state.warm_x[0].abs().max() == 0.0
    assert torch.equal(bc.state.model.A[0], model_pre[0])
    assert torch.equal(bc.state.warm_x[1:], warm_pre[1:])
    assert torch.equal(bc.state.model.A[1:], model_pre[1:])

    bc.reset(full=True, mask=np.array([False, True, False]))
    assert torch.equal(bc.state.model.A[1], pipe.model0.A)
    assert torch.equal(bc.state.model.A[2], model_pre[2])
    np.testing.assert_array_equal(bc.clocks, [0, 0, 6])

    assert bool(torch.isfinite(bc.step(x)).all())
    with pytest.raises(ValueError):
        bc.reset(mask=[True, False])


def test_masked_reset_matches_fresh_single(duffing_pipe):
    """tests/test_controller.py:199-230 on the port: plant 0 of a fleet of
    two, reset by mask after 5 calls, against a Controller fed the same
    measurements and reset the same way, 5 calls before and 5 after.
    Held to 1e-9 (the JAX package's fleet-against-single tolerance,
    tests/test_controller_equiv.py:191), not the JAX test's 1e-12: on the
    CPU a one-row ``F.linear`` in the MLP lift rounds otherwise than a
    two-row one (measured: u 1.2e-10 apart after the reset). The
    per-plant clock itself is held to 1e-12 by the next test."""
    pipe = duffing_pipe
    plant = _plant(pipe)
    bc = BatchedController.from_pipeline(pipe, 2)
    single = Controller.from_pipeline(pipe)
    x = torch.tensor([[-1.5, 1.0], [0.5, -0.5]], dtype=F64)
    for call in range(10):
        if call == 5:
            bc.reset(mask=[True, False])
            single.reset()
            np.testing.assert_array_equal(bc.clocks, [0, 5])
        u = bc.step(x)
        np.testing.assert_allclose(u[0].numpy(), single.step(x[0]).numpy(),
                                   rtol=0, atol=1e-9)
        x = plant(x, u)


# the per-plant clock matters wherever the step enters: the dither probe,
# a time-varying reference, the windowed refit schedule (cadence 3, late
# chain 12 from warm-up 10: tests/test_controller_equiv.py:86-98) and the
# Woodbury anchor; the plain duffing preset is the JAX test's case
CLOCK_CASES = {
    "duffing": dict(),
    "dither": dict(update=dict(mode="rls_sqrt", ridge=1e-6, dither=0.02)),
    "sine": dict(reference="sine"),
    "cadence_late": dict(update=dict(
        mode="windowed", window=32, window_refit_every=3,
        window_filter_late=12, window_filter_warmup=10)),
    "woodbury_anchor": dict(update=dict(
        mode="windowed", window=32, window_carry="woodbury", window_anchor=4,
        ridge=1e-2)),
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
def test_per_plant_clocks_match_the_int_path(case):
    """After a masked reset the fleet's clocks differ (plant 0 counts
    0..11, plant 1 from 6), so each call takes the per-plant path; at each
    call, a twin fleet holding two copies of plant 0's state with both
    clocks at plant 0's (the int path, the loop's) gives plant 0 the same
    input, to 1e-12 (observed: equal bit for bit)."""
    spec = CLOCK_CASES[case]
    cfg = _small(TC, **spec.get("update", {}))
    cfg.reference = spec.get("reference", cfg.reference)
    pipe = build_pipeline(cfg, device="cpu")
    plant = _plant(pipe)
    bc = BatchedController.from_pipeline(pipe, 2)
    x = torch.tensor([[-1.5, 1.0], [0.5, -0.5]], dtype=F64)
    for _ in range(6):
        x = plant(x, bc.step(x))
    bc.reset(mask=[True, False])
    for _ in range(12):
        assert bc.clocks[0] != bc.clocks[1]
        twin = BatchedController.from_pipeline(pipe, 2)
        twin.state = tree_map(lambda a: a[:1].expand_as(a).clone(), bc.state)
        twin._k = np.full(2, bc.clocks[0])
        u = bc.step(x)
        u_twin = twin.step(x[:1].expand(2, -1))
        np.testing.assert_allclose(u[0].numpy(), u_twin[0].numpy(), rtol=0,
                                   atol=1e-12)
        x = plant(x, u)


def _window_state(rng, batch, carry=False, ridge=1e-5, nlift=4, m=1, n=2,
                  w=16):
    state = window_init(w, nlift, m, n, F64, carry=carry, ridge=ridge)
    zs = torch.tensor(rng.normal(size=(2 * w, nlift)))
    state = window_prefill(state, zs[:w], torch.tensor(rng.normal(size=(w, m))),
                           zs[w:], torch.tensor(rng.normal(size=(w, n))))
    return tree_map(lambda t: t.expand((batch,) + t.shape).clone(), state)


def test_per_plant_estimator_schedules_match_the_int_path():
    """One estimator update with per-plant steps [3, 4, 9, 11, 12, 13, 14,
    15] against the int path (the same batch, each row read at its own
    step): the windowed refit with cadence 3 and the late chain 12 from
    warm-up 10 (warm-up rows, late rows due and held rows in one call)
    and the Woodbury anchor every 4; equal bit for bit. With no plant due
    the model is held."""
    rng = np.random.default_rng(5)
    steps = torch.tensor([3, 4, 9, 11, 12, 13, 14, 15])
    b, nlift, m, n = steps.shape[0], 4, 1, 2
    d = type("D", (), {"nlift": nlift})()
    model = LinearModel(*(0.3 * torch.tensor(rng.normal(size=(b,) + s))
                          for s in ((nlift, nlift), (nlift, m), (n, nlift))))
    obs = [torch.tensor(rng.normal(size=(b, k))) for k in (nlift, m, nlift, n)]
    refit = dict(update="windowed", window_refit_every=3,
                 window_filter_late=12, window_filter_warmup=10)
    woodbury = dict(update="windowed", window_carry="woodbury",
                    window_anchor=4, rls_ridge=1e-2)
    for kw in (refit, woodbury):
        upd = tcore.make_estimator_update(d, tcore.EngineConfig(**kw))
        state = _window_state(rng, b, carry="window_carry" in kw,
                              ridge=max(kw.get("rls_ridge", 0.0), 1e-5))
        per_plant = tree_leaves(upd(state, model, *obs, steps))
        for i, k in enumerate(steps.tolist()):
            one = tree_leaves(upd(state, model, *obs, k))
            for got, want in zip(per_plant, one, strict=True):
                assert torch.equal(got[i], want[i]), (kw, k)
    upd = tcore.make_estimator_update(d, tcore.EngineConfig(**refit))
    _, held = upd(_window_state(rng, b), model, *obs,
                  torch.tensor([13, 14] * (b // 2)))
    assert all(torch.equal(a, c) for a, c in zip(held, model))


def test_per_plant_reference_windows_match_the_int_path():
    """Every reference generator at per-plant steps gives, row by row, the
    window of the int path, bit for bit: the time-varying ones one window
    a plant, the constant ones their shared window."""
    steps = torch.tensor([0, 7, 199, 200, 433])
    for name in ("constant", "sine", "square", "chirp", "cos_sin_mix"):
        cfg = _small(TC)
        cfg.reference = name
        ref_fn = ref_fn_for(cfg, 2, "cpu")
        windows = ref_fn(steps)
        for i, k in enumerate(steps.tolist()):
            want = ref_fn(k)
            got = windows[i] if windows.dim() == 3 else windows
            assert torch.equal(got, want), (name, k)


def test_controller_state_checkpoint_resumes_identically(duffing_pipe,
                                                         tmp_path):
    """A ControllerState (with its certificate under terminal synthesis
    and its () and None parts) through ``save_pytree`` / ``load_pytree``
    resumes to the same inputs, bit for bit."""
    for pipe in (duffing_pipe, build_pipeline(_small(TC, "revise2_duffing"),
                                              device="cpu")):
        plant = _plant(pipe)
        ctrl = Controller.from_pipeline(pipe)
        x = pipe.x_init
        for _ in range(6):
            x = plant(x[None], ctrl.step(x)[None])[0]
        path = str(tmp_path / "state.npz")
        save_pytree(path, ctrl.state, meta=int(ctrl.clocks[0]))
        other = Controller.from_pipeline(pipe)
        other.state, k = load_pytree(path, other.state)
        other._k = np.array([k])
        for _ in range(4):
            u = ctrl.step(x)
            assert torch.equal(u, other.step(x))
            x = plant(x[None], u[None])[0]


def test_controller_casts_its_input(duffing_pipe):
    """``step`` casts x to the controller's dtype: a float32 or numpy
    measurement leaves the float64 state float64, and the same values give
    the same input."""
    a, b = (Controller.from_pipeline(duffing_pipe) for _ in range(2))
    x = duffing_pipe.x_init
    ua = a.step(x.float())
    ub = b.step(x.float().double().numpy())
    assert ua.dtype == F64 and a.state.z_prev.dtype == F64
    assert torch.equal(ua, ub)


def test_controllers_refuse_a_missing_card(duffing_pipe):
    """Without ``device`` the controllers run on the card, and raise where
    there is none: they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pipe = duffing_pipe
    args = (pipe.dictionary, pipe.engine_cfg, pipe.params, _ref_fn(pipe),
            pipe.model0, pipe.rls0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Controller(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedController(*args, batch=2)
