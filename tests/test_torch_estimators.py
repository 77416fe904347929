"""The remaining estimators of koopmanx_torch against the JAX package: the
Sherman-Morrison RLS (``update='rls'``), the storage method and the
Gram-carry RLS (``'rls_chol'``) with both model extractions, the ridge of
``spd_inverse``, ``change_reset`` on the Gram carry, the round trip of
every estimator state through ``convert``, the batched closed loop under
each mode against JAX ``run_batch``, and the options of later items,
which build. float64 on the CPU; inputs from numpy with a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.edmd import batch as jbatch  # noqa: E402
from koopmanx.edmd import rls as jrls  # noqa: E402
from koopmanx.edmd import windowed as jwin  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.ops.linalg import spd_inverse as j_spd_inverse  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import model_from_rls as j_model_from_rls  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.edmd import batch as tbatch  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.edmd.windowed import WindowState  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.ops.linalg import spd_inverse  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import engine_config  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import RLSState, model_from_rls  # noqa: E402

from test_torch_vdp import (  # noqa: E402
    BATCH,
    STEPS,
    VDP,
    arrays_from_jax,
    assert_logs_match,
    run_both,
)

F64 = torch.float64
NLIFT, M, N = 5, 1, 2
DUFFING = (jlib.DuffingParams, tlib.DuffingParams, [-0.5, 1.0, -1.0],
           [-5.0, 2.0, -0.5])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _observations(seed, steps, batch=6):
    """``steps`` observations (z, u, z+, x_target) for ``batch``
    scenarios, O(1) entries."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(steps, batch, k))
                 for k in (NLIFT, M, NLIFT, N))


def _close(t, j, rel):
    """max |t - j| within ``rel`` of max |j|, leaf by leaf."""
    for a, b in zip(t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (
            np.abs(a - b).max(), np.abs(b).max())


def _replicate(state, batch):
    return type(state)(*(np.broadcast_to(np.asarray(v), (batch,) + v.shape)
                         for v in state))


def _to_torch(cls, state):
    return cls(*(torch.tensor(np.ascontiguousarray(v)) for v in state))


@pytest.mark.parametrize("lam", [1.0, 0.98])
@pytest.mark.parametrize("symmetrize", [False, True], ids=["raw", "sym"])
def test_rls_updates_match_jax(symmetrize, lam):
    """Ten SM updates of both regressions from the scaled-identity prior
    (1e4 / 1e2), with and without re-symmetrizing and with forgetting,
    then the model: every leaf within 1e-11 of JAX's relative to its
    largest entry (the same float64 operations up to summation order)."""
    z, u, zn, x = _observations(1, 10)
    jst = _replicate(jrls.rls_init(NLIFT, M, N, 1e4, 1e2, jnp.float64), 6)
    tst = _to_torch(RLSState, jst)
    jst = jrls.RLSState(*(jnp.asarray(v) for v in jst))
    jab = jax.vmap(lambda s, a, b, c: jrls.rls_update_ab(
        s, a, b, c, lam=lam, symmetrize=symmetrize))
    jc = jax.vmap(lambda s, a, c: jrls.rls_update_c(
        s, a, c, lam=lam, symmetrize=symmetrize))
    for k in range(10):
        jst = jc(jab(jst, z[k], u[k], zn[k]), z[k], x[k])
        t = [torch.tensor(v[k]) for v in (z, u, zn, x)]
        tst = trls.rls_update_ab(tst, t[0], t[1], t[2], lam=lam,
                                 symmetrize=symmetrize)
        tst = trls.rls_update_c(tst, t[0], t[3], lam=lam,
                                symmetrize=symmetrize)
    _close(tst, jst, 1e-11)
    _close(model_from_rls(tst, NLIFT), j_model_from_rls(jst, NLIFT), 1e-11)
    sym = (tst.invG - tst.invG.transpose(-1, -2)).abs().max()
    assert (sym == 0) if symmetrize else True


def _train_stats(seed):
    rng = np.random.default_rng(seed)
    zx, zy = rng.normal(size=(60, NLIFT)), rng.normal(size=(60, NLIFT))
    uu, xx = rng.normal(size=(60, M)), rng.normal(size=(60, N))
    return [np.asarray(v) for v in jbatch.gram_stats(
        *(jnp.asarray(a) for a in (zx, zy, uu, xx)))]


def test_storage_matches_jax():
    """The Grams of 60 training snapshots grown by eight observations of
    six scenarios, then the model from two pseudo-inverses with JAX's
    cutoff: the Grams within 1e-12, the model within 1e-10 relative (two
    LAPACK SVDs); ``storage_init`` keeps the training Grams."""
    stats = _train_stats(2)
    t_init = trls.storage_init(tbatch.GramStats(*map(torch.tensor, stats)))
    for a, b in zip(t_init, stats[:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    jst = _replicate(jrls.StorageState(*stats[:4]), 6)
    tst = _to_torch(trls.StorageState, jst)
    jst = jrls.StorageState(*(jnp.asarray(v) for v in jst))
    z, u, zn, x = _observations(3, 8)
    for k in range(8):
        jst = jax.vmap(jrls.storage_update)(jst, z[k], u[k], zn[k], x[k])
        tst = trls.storage_update(tst, *(torch.tensor(v[k])
                                         for v in (z, u, zn, x)))
    _close(tst, jst, 1e-12)
    _close(trls.storage_model(tst, NLIFT),
           jax.vmap(lambda s: jrls.storage_model(s, NLIFT))(jst), 1e-10)


def test_pinv_of_a_non_finite_matrix_is_nan_as_in_jax():
    """A Gram with a NaN or an inf gives an all-NaN pseudo-inverse (JAX's
    result; torch's SVD raises) and leaves the other scenarios' alone."""
    stats = _train_stats(4)
    g = np.stack([stats[1]] * 3)
    g[1, 0, 0], g[2, 1, 2] = np.nan, np.inf
    out = tbatch.pinv(torch.tensor(g)).numpy()
    ref = np.asarray(jnp.linalg.pinv(jnp.asarray(g)))
    assert np.isnan(out[1:]).all() and np.isnan(ref[1:]).all()
    np.testing.assert_allclose(out[0], ref[0], rtol=0,
                               atol=1e-10 * np.abs(ref[0]).max())


@pytest.mark.parametrize("lam", [1.0, 0.98])
@pytest.mark.parametrize("schulz_iters", [0, 24], ids=["spd", "schulz"])
def test_gram_rls_matches_jax(schulz_iters, lam):
    """Ten Gram-carry updates from the prior G0 = I / 1e4, Q0 = I / 1e2,
    with and without forgetting, then the model by the exact SPD inverse
    with the engine's ridge (1e-7) or by the legacy 24-step Newton-Schulz
    chain: the carry within 1e-12 and the model within 1e-9 of JAX's,
    relative to each leaf's largest entry."""
    z, u, zn, x = _observations(5, 10)
    jst = _replicate(jrls.gram_rls_init(NLIFT, M, N, 1e4, 1e2, jnp.float64), 6)
    tst = _to_torch(trls.GramRLSState, jst)
    jst = jrls.GramRLSState(*(jnp.asarray(v) for v in jst))
    jup = jax.vmap(lambda s, a, b, c, d: jrls.gram_rls_update(
        s, a, b, c, d, lam=lam))
    for k in range(10):
        jst = jup(jst, z[k], u[k], zn[k], x[k])
        tst = trls.gram_rls_update(tst, *(torch.tensor(v[k])
                                          for v in (z, u, zn, x)), lam=lam)
    _close(tst, jst, 1e-12)
    jmodel = jax.vmap(lambda s: jrls.gram_rls_model(
        s, NLIFT, ridge=1e-7, schulz_iters=schulz_iters))(jst)
    _close(trls.gram_rls_model(tst, NLIFT, ridge=1e-7,
                               schulz_iters=schulz_iters), jmodel, 1e-9)


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_spd_inverse_ridge_matches_jax(eps, block):
    """``spd_inverse(k, eps=...)`` inverts k + eps I as JAX's does, within
    1e-12 relative; ``eps=0`` is the call without it, bit for bit."""
    rng = np.random.default_rng(int(eps * 1e3) + block)
    a = rng.normal(size=(5, 9, 9))
    k = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(9)
    out = spd_inverse(torch.tensor(k), block=block, eps=eps).numpy()
    ref = np.asarray(j_spd_inverse(jnp.asarray(k), eps=eps, block=block))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(out @ (k + eps * np.eye(9)),
                               np.broadcast_to(np.eye(9), k.shape), rtol=0,
                               atol=1e-8)
    if eps == 0.0:
        np.testing.assert_array_equal(
            out, spd_inverse(torch.tensor(k), block=block).numpy())


def test_change_reset_on_the_gram_carry_matches_jax():
    """Five scenarios: unwarmed, warmed below the trigger, triggered (two),
    and at the threshold: the triggered ones' K_A, g, barX and q scaled by
    the reset factor, the residual EMA as JAX's, 1e-15 relative."""
    rng = np.random.default_rng(6)
    st = jrls.GramRLSState(*(rng.normal(size=(5,) + s) for s in (
        (NLIFT, NLIFT + M), (NLIFT + M, NLIFT + M), (N, NLIFT),
        (NLIFT, NLIFT))))
    res_ema = np.array([0.0, 1.0, 1.0, 0.5, 1.0])
    residual = np.array([2.0, 1.5, 5.0, 4.0, 3.0])
    kw = dict(update="rls_chol", reset_mult=3.0, reset_factor=1e-3)
    jcfg = jcore.EngineConfig(**kw)
    jout, jema = jax.vmap(lambda s, e, r: jcore.change_reset(jcfg, s, e, r))(
        jrls.GramRLSState(*map(jnp.asarray, st)), jnp.asarray(res_ema),
        jnp.asarray(residual))
    tout, tema = tcore.change_reset(
        tcore.EngineConfig(**kw), _to_torch(trls.GramRLSState, st),
        torch.tensor(res_ema), torch.tensor(residual))
    _close(tout, jout, 1e-15)
    np.testing.assert_allclose(tema.numpy(), np.asarray(jema), rtol=1e-15)
    scaled = [bool(np.allclose(tout.g[i].numpy(), 1e-3 * st.g[i]))
              for i in range(5)]
    assert scaled == [False, False, True, True, False]


def _flagship(mode, **update):
    """The flagship scenario at test size for ``update.mode=mode``: 16
    steps with the switch at 8, 20x20 data, a random-init MLP 2-16-16-16-8,
    f64, horizon 10, the kernel route."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.duffing_nn_preset()
        cfg.steps, cfg.dtype, cfg.switch_step = STEPS, "float64", STEPS // 2
        cfg.mpc.horizon, cfg.mpc.qp_backend = 10, "pallas"
        cfg.data = C.DataConfig(n_step=20, n_traj=20)
        cfg.lift = C.LiftConfig(kind="mlp", nlift=8, hidden=16)
        cfg.update = dataclasses.replace(cfg.update, mode=mode, **update)
        cfgs.append(cfg)
    return cfgs


def _preset(name):
    cfgs = []
    for C in (JC, TC):
        cfg = C.PRESETS[name]()
        cfg.steps, cfg.dtype, cfg.switch_step = STEPS, "float64", STEPS // 2
        cfg.mpc.horizon, cfg.mpc.qp_backend = 10, "pallas"
        cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
        cfgs.append(cfg)
    return cfgs


def _resets(residual, mult, beta=0.98):
    """How many steps ``change_reset`` triggers, replayed from the logged
    pre-update residuals of each scenario."""
    count = 0
    for row in residual:
        ema = 0.0
        for r in row:
            trig = ema > 0 and r > mult * ema
            count += trig
            if ema <= 0:
                ema = r
            elif not trig:
                ema = beta * ema + (1 - beta) * r
    return count


LOOPS = {
    "flagship-rls": lambda: _flagship("rls"),
    "flagship-rls_chol-reset": lambda: _flagship("rls_chol", ridge=1e-2,
                                                 reset_mult=4.0),
    "vanderpol_rbf-storage": lambda: _preset("vanderpol_rbf"),
    "duffing_rbf-storage": lambda: _preset("duffing_rbf"),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_estimator_loop_matches_jax_run_batch(case):
    """4 scenarios x 16 steps through the switch at 8, float64, under each
    mode's engine branch, guard and reset against JAX ``run_batch``: x to
    1e-9 and u to 1e-8 per scenario and step, or ten times the JAX
    package's own one-ulp floor there where larger (``assert_logs_match``);
    the storage runs within 1e-6 in any case. The Gram-carry run triggers
    its reset; the final estimator state has the mode's type."""
    jcfg, tcfg = LOOPS[case]()
    plant = VDP if tcfg.system == "vanderpol" else DUFFING
    jlogs, log, carry, pipe = run_both(jcfg, tcfg, plant)
    diff = assert_logs_match(jlogs, log)
    kind = {"rls": RLSState, "rls_chol": trls.GramRLSState,
            "storage": trls.StorageState}[tcfg.update.mode]
    assert type(carry.rls) is kind and type(pipe.rls0) is kind
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
    if tcfg.update.mode == "storage":
        assert max(diff["x"], diff["u"]) <= 1e-6, diff
    if tcfg.update.reset_mult > 0:
        assert _resets(log.residual.numpy(), tcfg.update.reset_mult) > 0


def _jax_states():
    """One scenario's initial state of each estimator of the JAX package
    (nlift 5, m 1, n 2; the window 16 rows, prefilled from 20)."""
    stats = jbatch.GramStats(*(jnp.asarray(v) for v in _train_stats(7)))
    nl = NLIFT
    return {
        "rls": jrls.rls_init(nl, M, N, 1e4, 1e2, jnp.float64),
        "rls_chol": jrls.gram_rls_init(nl, M, N, 1e4, 1e2, jnp.float64),
        "storage": jrls.storage_init(stats),
        "rls_sqrt": jrls.sqrt_rls_init(nl, M, N, 1e4, 1e2, jnp.float64),
        "windowed": jwin.window_prefill(
            jwin.window_init(16, nl, M, N, jnp.float64),
            *(jnp.asarray(np.random.default_rng(8).normal(size=(20, k)))
              for k in (nl, M, nl, N))),
    }


@pytest.fixture(scope="module")
def flagship_arrays():
    jcfg, _ = _flagship("rls")
    jcfg.lift.nlift = NLIFT
    return arrays_from_jax(j_build_pipeline(jcfg))


@pytest.mark.parametrize("mode", ["rls", "rls_chol", "storage", "rls_sqrt",
                                  "windowed"])
def test_convert_round_trip_of_each_estimator_state(flagship_arrays, mode):
    """Each estimator state of the JAX package, as numpy arrays by field
    name, becomes the port's state of the same type and comes back from
    ``pipeline_to_numpy`` unchanged."""
    arrays = dict(flagship_arrays)
    state = _jax_states()[mode]
    arrays["rls0"] = {k: np.asarray(v) for k, v in state._asdict().items()
                      if v is not None and not isinstance(v, tuple)}
    _, tcfg = _flagship(mode)
    tcfg.lift.nlift = NLIFT
    if mode == "windowed":
        tcfg.update.window = 16
    pipe = pipeline_from_numpy(arrays, tcfg, device="cpu", dtype=F64)
    kind = {"rls": RLSState, "rls_chol": trls.GramRLSState,
            "storage": trls.StorageState, "rls_sqrt": trls.SqrtRLSState,
            "windowed": WindowState}[mode]
    assert type(pipe.rls0) is kind
    back = pipeline_to_numpy(pipe)["rls0"]
    for k, v in arrays["rls0"].items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("mode", ["rls", "rls_chol", "storage", "rls_sqrt"])
def test_initial_estimator_of_each_mode(mode):
    """``build_pipeline``'s estimator state: the JAX package's prior for
    the SM, Gram-carry and square-root RLS (``c_ab``, ``c_c``) bit for bit,
    and for storage the Grams of the port's own lifted training snapshots
    (``gram_stats``), 1e-12 relative."""
    _, cfg = _flagship(mode)
    cfg.steps = 2
    pipe = t_build_pipeline(cfg, device="cpu")
    nl, uc = pipe.dictionary.nlift, cfg.update
    if mode == "storage":
        with torch.no_grad():
            ref = tbatch.gram_stats(pipe.dictionary(pipe.data.x),
                                    pipe.dictionary(pipe.data.y),
                                    pipe.data.u, pipe.data.x)
        _close(pipe.rls0, ref[:4], 1e-12)
        return
    init = {"rls": jrls.rls_init, "rls_chol": jrls.gram_rls_init,
            "rls_sqrt": jrls.sqrt_rls_init}[mode]
    ref = init(nl, M, N, uc.c_ab, uc.c_c, jnp.float64)
    assert type(pipe.rls0).__name__ == type(ref).__name__
    for a, b in zip(pipe.rls0, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_convert_refuses_an_unknown_estimator_state(flagship_arrays):
    arrays = dict(flagship_arrays, rls0={"P": np.eye(3)})
    _, tcfg = _flagship("rls")
    tcfg.lift.nlift = NLIFT
    with pytest.raises(ValueError, match="no estimator state"):
        pipeline_from_numpy(arrays, tcfg, device="cpu", dtype=F64)


@pytest.mark.parametrize("change", [
    lambda c: setattr(c.mpc, "controller", "lqr"),
    lambda c: (setattr(c.mpc, "terminal_synthesis", True),
               setattr(c.mpc, "terminal_mode", "lmi")),
    lambda c: (setattr(c.mpc, "qp_kkt_refine", 2),
               setattr(c.mpc, "qp_kkt_reanchor", 8),
               setattr(c.mpc, "qp_kkt_bf16", True)),
], ids=["lqr", "terminal_synthesis", "qp_kkt_refine"])
def test_later_items_stay_refused(change):
    """Options of later items build on the VDP preset as on any other:
    the LQR controller (item 15), terminal synthesis in its LMI mode (item
    14b), and the carried and bf16 KKT inverses (L3), each carried into
    the engine config (tests/test_torch_lqr.py, tests/test_torch_lmi.py,
    tests/test_torch_kkt_refine.py)."""
    cfg = TC.vdp_lifted_preset()
    change(cfg)
    ecfg = engine_config(cfg)
    mc = cfg.mpc
    assert (ecfg.controller, ecfg.terminal_mode, ecfg.qp_kkt_refine,
            ecfg.qp_kkt_reanchor, ecfg.qp_kkt_bf16) == (
        mc.controller, mc.terminal_mode, mc.qp_kkt_refine,
        mc.qp_kkt_reanchor, mc.qp_kkt_bf16)
    assert ecfg.qp_config.kkt_bf16 == mc.qp_kkt_bf16


def test_unknown_update_mode_is_refused():
    with pytest.raises(ValueError, match="unknown update"):
        tcore.check_supported(tcore.EngineConfig(update="kalman"))
