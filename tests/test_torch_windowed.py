"""The windowed estimator and the tank loop of koopmanx_torch against the
JAX package: the Newton-Schulz inverse, the ring buffers and the refit,
the estimator update's cadence and filter schedule, and the batched tank
closed loop (du formulation, applied window folded into du_0's bounds,
thinplate RBF lift, box-ADMM route) against JAX ``run_batch`` on the same
pipeline, carried across as numpy arrays. float64 on the CPU; inputs from
numpy with a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.edmd import rls as jrls  # noqa: E402
from koopmanx.edmd import windowed as jwin  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import TankParams as JTank  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.edmd import windowed as twin  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import replicate  # noqa: E402
from koopmanx_torch.systems.library import TankParams as TTank  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
BATCH, STEPS, WINDOW = 4, 80, 32
POISONED = BATCH  # the extra scenario of the poisoned run, x0 = NaN


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, data_cls):
    """The tank preset at test size: 80 steps, a window of 32 (it wraps
    after 32 steps), the always-refit warm-up 40 steps, then a refit every
    8th step with the 12-step late chain; the switch at 40; 20x20 data;
    f64; the kernel route (its plain version on CPU tensors)."""
    cfg.steps = STEPS
    cfg.dtype = "float64"
    cfg.switch_step = STEPS // 2
    cfg.mpc.qp_backend = "pallas"
    cfg.data = data_cls(n_step=20, n_traj=20, u_range=(-5.0, 5.0),
                        clamp_x0=True)
    uc = cfg.update
    uc.window, uc.window_filter_warmup = WINDOW, 40
    uc.window_refit_every, uc.window_filter_late = 8, 12
    return cfg


def _arrays_from_jax(pipe, state_augmented=False):
    """The JAX pipeline as ``convert.pipeline_from_numpy`` reads it: a
    normalized RBF lift (params = (centers, mu, sc)), the windowed rings."""
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    centers, mu, sc = n(pipe.dictionary.params)
    p, r = pipe.params, pipe.rls0
    keys = ("q_block", "r_block", "u_min", "u_max", "cy", "applied_min",
            "applied_max", "ref_state")
    return {
        "rbf": {"centers": centers, "kind": pipe.config.lift.rbf_type},
        "state_augmented": state_augmented,
        "normalizer": (mu, sc),
        "model0": tuple(n(pipe.model0)),
        "rls0": {k: n(getattr(r, k)) for k in ("zx", "u", "zy", "x", "idx")},
        "params": {k: None if getattr(p, k) is None else n(getattr(p, k))
                   for k in keys},
        "x_init": n(pipe.x_init),
    }


@pytest.fixture(scope="module")
def jax_pipe():
    return j_build_pipeline(_configure(JC.tank_preset(), JC.DataConfig))


@pytest.fixture(scope="module")
def scenarios():
    """BATCH clean scenarios (x0 ~ U[0, 2]^2, param_scale 0.15) and one
    more whose x0 is NaN."""
    rng = np.random.default_rng(0)
    b = BATCH + 1
    x0 = rng.uniform(0.0, 2.0, size=(b, 2))
    x0[POISONED] = np.nan
    th0 = np.array([0.5, 0.4, 0.2, 0.3]) * (1 + rng.uniform(-.15, .15, (b, 4)))
    th1 = np.array([0.53, 0.3, 0.1, 0.35]) * (1 + rng.uniform(-.15, .15, (b, 4)))
    return x0, th0, th1


@pytest.fixture(scope="module")
def jax_run(jax_pipe, scenarios):
    """JAX ``run_batch`` over all BATCH + 1 scenarios; ``vmap`` keeps them
    independent, so the first BATCH are the clean run."""
    x0, th0, th1 = scenarios
    b = x0.shape[0]
    rep = lambda v: jnp.broadcast_to(v, (b,) + v.shape)
    return j_run_batch(
        jax_pipe.closed_loop,
        jax.tree_util.tree_map(rep, jax_pipe.params), jnp.asarray(x0),
        jax.tree_util.tree_map(rep, jax_pipe.model0),
        jax.tree_util.tree_map(rep, jax_pipe.rls0),
        JTank(*jnp.asarray(th0.T)), JTank(*jnp.asarray(th1.T)),
    )


def _torch_pipe(jax_pipe, **update):
    cfg = _configure(TC.tank_preset(), TC.DataConfig)
    for k, v in update.items():
        setattr(cfg.update, k, v)
    return pipeline_from_numpy(_arrays_from_jax(jax_pipe), cfg, device="cpu",
                               dtype=F64)


def _torch_run(pipe, scenarios, batch):
    x0, th0, th1 = (v[:batch] for v in scenarios)
    return t_run_batch(
        pipe.closed_loop, replicate(pipe.params, batch), torch.tensor(x0),
        replicate(pipe.model0, batch), replicate(pipe.rls0, batch),
        TTank(*torch.tensor(th0.T)), TTank(*torch.tensor(th1.T)),
    )


@pytest.mark.parametrize("iters", [24, 12])
def test_schulz_inverse_matches_jax(iters):
    """Batched SPD Grams of the window's kind (ridge 3e-2, condition up to
    ~1e3, so 12 steps leave the weak directions unconverged): the same
    products in the same order, 1e-12 relative to the inverse's scale."""
    rng = np.random.default_rng(iters)
    v = rng.normal(size=(6, 40, 11)) * np.geomspace(1.0, 0.05, 11)
    g = np.einsum("bwi,bwj->bij", v, v) + 3e-2 * np.eye(11)
    ref = np.asarray(jax.vmap(lambda a: jrls.schulz_inverse(a, iters))(
        jnp.asarray(g)))
    out = trls.schulz_inverse(torch.tensor(g), iters).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("schulz_iters", [0, 24])
def test_window_ring_and_refit_match_jax(schulz_iters):
    """Prefill with more snapshots than the window holds (the last W are
    kept), then per-scenario updates from cursors 0, 5 and W-1 (the last
    wraps to 0), and the refit by the exact and the truncated inverse.
    The rings and cursors are copies: equal bit for bit; the refit to
    1e-10 (Gram condition ~1e3)."""
    rng = np.random.default_rng(7)
    w, nlift, m, n = 8, 4, 1, 2
    snap = [rng.normal(size=(13, k)) for k in (nlift, m, nlift, n)]
    j0 = jwin.window_prefill(
        jwin.window_init(w, nlift, m, n, dtype=jnp.float64),
        *(jnp.asarray(a) for a in snap))
    t0 = twin.window_prefill(twin.window_init(w, nlift, m, n, dtype=F64),
                             *(torch.tensor(a) for a in snap))
    np.testing.assert_array_equal(t0.zx.numpy(), np.asarray(j0.zx))
    assert int(t0.idx) == int(j0.idx) == 0  # a full window
    cursors = np.array([0, 5, w - 1], dtype=np.int32)
    b = len(cursors)
    obs = [rng.normal(size=(b, k)) for k in (nlift, m, nlift, n)]
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (b,) + a.shape), j0)._replace(
            idx=jnp.asarray(cursors))
    jnew = jax.vmap(jwin.window_update)(jstate, *(jnp.asarray(a) for a in obs))
    tstate = replicate(t0, b)._replace(idx=torch.tensor(cursors))
    tnew = twin.window_update(tstate, *(torch.tensor(a) for a in obs))
    for k in ("zx", "u", "zy", "x", "idx"):
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      np.asarray(getattr(jnew, k)))
    assert tnew.idx.tolist() == [1, 6, 0]
    assert tstate.idx.tolist() == cursors.tolist()  # out of place
    jm = jax.vmap(lambda s: jwin.window_model(s, nlift, ridge=3e-2,
                                              schulz_iters=schulz_iters))(jnew)
    tm = twin.window_model(tnew, nlift, ridge=3e-2, schulz_iters=schulz_iters)
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("step", [3, 41, 48])
def test_windowed_estimator_update_schedule_matches_jax(step):
    """The engine's windowed update at step 3 (warm-up: refit with the
    24-step chain), 41 (past the warm-up, off the cadence: the model is
    held, the ring still absorbs) and 48 (on the cadence: the 12-step late
    chain), with one scenario's observation non-finite: that scenario keeps
    its ring, its cursor and its model, in both packages."""
    rng = np.random.default_rng(step)
    w, nlift, m, n, b = 16, 4, 1, 2, 3
    snap = [rng.normal(size=(w, k)) for k in (nlift, m, nlift, n)]
    obs = [rng.normal(size=(b, k)) for k in (nlift, m, nlift, n)]
    obs[2][1, 0] = np.nan
    a0 = 0.5 * np.eye(nlift) + 0.05 * rng.normal(size=(b, nlift, nlift))
    b0, c0 = rng.normal(size=(b, nlift, m)), rng.normal(size=(b, n, nlift))
    kw = dict(update="windowed", rls_ridge=3e-2, window_filter_warmup=40,
              window_refit_every=8, window_filter_late=12)
    dummy = type("D", (), {"nlift": nlift})()
    jupd = jcore.make_estimator_update(dummy, jcore.EngineConfig(**kw))
    j0 = jwin.window_prefill(jwin.window_init(w, nlift, m, n, jnp.float64),
                             *(jnp.asarray(a) for a in snap))
    jr, jm = jax.vmap(lambda s, mm, *a: jupd(s, mm, *a, step),
                      in_axes=(None, 0, 0, 0, 0, 0))(
        j0, JModel(*(jnp.asarray(v) for v in (a0, b0, c0))),
        *(jnp.asarray(v) for v in obs))
    tupd = tcore.make_estimator_update(dummy, tcore.EngineConfig(**kw))
    t0 = twin.window_prefill(twin.window_init(w, nlift, m, n, F64),
                             *(torch.tensor(a) for a in snap))
    tr, tm = tupd(replicate(t0, b), TModel(*(torch.tensor(v)
                                             for v in (a0, b0, c0))),
                  *(torch.tensor(v) for v in obs), step)
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)
    for k in ("zx", "u", "zy", "x", "idx"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)))
    assert tr.idx.tolist() == [1, 0, 1]  # the NaN scenario held its cursor
    np.testing.assert_array_equal(tm.A[1].numpy(), a0[1])
    if step == 41:  # held everywhere
        np.testing.assert_array_equal(tm.A.numpy(), a0)


def test_tank_loop_matches_jax_run_batch(jax_pipe, jax_run, scenarios):
    """4 scenarios x 80 steps, window 32 (it wraps), the switch and the end
    of the warm-up at 40, refit every 8th step after it with the late
    chain: the first 16 steps to 1e-9 (the same f64 arithmetic up to
    summation order), the x2 tail mean to 1e-3 relative; no kernel launch
    on CPU tensors; the du box, the applied window and x >= 0 held."""
    jcarry, jlog = jax_run
    pipe = _torch_pipe(jax_pipe)
    launches = box_admm.launches
    carry, log = _torch_run(pipe, scenarios, BATCH)
    assert box_admm.launches == launches
    jx, tx = np.asarray(jlog.x)[:BATCH], log.x.numpy()
    assert tx.shape == (BATCH, STEPS, 2)
    assert np.abs(tx[:, :16] - jx[:, :16]).max() <= 1e-9
    np.testing.assert_allclose(log.u.numpy()[:, :16],
                               np.asarray(jlog.u)[:BATCH, :16], rtol=0,
                               atol=1e-9)
    jt, tt = jx[:, -20:, 1].mean(), tx[:, -20:, 1].mean()
    assert abs(tt - jt) <= 1e-3 * abs(jt), (tt, jt)
    u = log.u.numpy()[..., 0]
    assert np.abs(np.diff(np.concatenate([np.zeros((BATCH, 1)), u], 1),
                          axis=1)).max() <= 0.5 + 1e-12
    assert np.abs(u).max() <= 8.0 and tx.min() >= 0.0
    assert carry.rls.idx.tolist() == [STEPS % WINDOW] * BATCH
    np.testing.assert_array_equal(carry.rls.idx.numpy(),
                                  np.asarray(jcarry.rls.idx)[:BATCH])


def test_tank_loop_poisoned_scenario_matches_jax(jax_pipe, jax_run,
                                                 scenarios):
    """A fifth scenario with x0 = NaN: the guard refuses every one of its
    updates (the ring's x row is NaN), so its ring, cursor and model stay
    the initial ones, as in JAX; the four clean scenarios run exactly as
    without it."""
    jcarry, jlog = jax_run
    pipe = _torch_pipe(jax_pipe)
    carry, log = _torch_run(pipe, scenarios, BATCH + 1)
    clean_carry, clean_log = _torch_run(pipe, scenarios, BATCH)
    np.testing.assert_array_equal(log.x.numpy()[:BATCH], clean_log.x.numpy())
    for k in ("zx", "u", "zy", "x", "idx"):
        t = getattr(carry.rls, k).numpy()
        np.testing.assert_array_equal(t[POISONED],
                                      np.asarray(getattr(jcarry.rls, k))[POISONED])
        np.testing.assert_array_equal(t[POISONED],
                                      getattr(pipe.rls0, k).numpy())
        np.testing.assert_array_equal(t[:BATCH],
                                      getattr(clean_carry.rls, k).numpy())
    assert int(carry.rls.idx[POISONED]) == 0
    for t, j in zip(carry.model, jcarry.model):
        np.testing.assert_array_equal(t.numpy()[POISONED],
                                      np.asarray(j)[POISONED])
    # the thinplate guard (a where on r^2 > 0) lifts NaN to 0, so the
    # controller still acts, on a finite lift, as in JAX
    assert np.isnan(log.x.numpy()[POISONED]).all()
    np.testing.assert_allclose(log.u.numpy()[POISONED],
                               np.asarray(jlog.u)[POISONED], rtol=0, atol=1e-9)


def test_refit_cadence_is_inert_under_the_warmup(jax_pipe, scenarios):
    """Below ``window_filter_warmup`` every step refits, so a cadence of 8
    runs bit for bit as a cadence of 1 (tests/test_sqrt_rls.py:142-161 for
    the JAX package)."""
    logs = []
    for every in (8, 1):
        cfg = _configure(TC.tank_preset(), TC.DataConfig)
        cfg.update.window_refit_every = every
        cfg.steps = 40  # = window_filter_warmup
        pipe = pipeline_from_numpy(_arrays_from_jax(jax_pipe), cfg,
                                   device="cpu", dtype=F64)
        logs.append(_torch_run(pipe, scenarios, BATCH)[1])
    for a, b in zip(*logs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_windowed_pipeline_round_trips(jax_pipe):
    arrays = _arrays_from_jax(jax_pipe)
    pipe = _torch_pipe(jax_pipe)
    back = pipeline_to_numpy(pipe)
    np.testing.assert_array_equal(back["rbf"]["centers"],
                                  arrays["rbf"]["centers"])
    assert back["rbf"]["kind"] == "thinplate"
    for k, v in arrays["rls0"].items():
        np.testing.assert_array_equal(back["rls0"][k], v)
    for k in ("applied_min", "applied_max", "cy", "u_min"):
        np.testing.assert_array_equal(back["params"][k], arrays["params"][k])
    np.testing.assert_array_equal(back["x_init"], [0.0, 0.0])
    x = np.random.default_rng(1).uniform(0, 2, size=(8, 2))
    x[0] = jax_pipe.dictionary.params[0][3]  # a center: r^2 = 0
    with torch.no_grad():
        z = pipe.dictionary(torch.tensor(x)).numpy()
    np.testing.assert_allclose(z, np.asarray(jax_pipe.dictionary(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
