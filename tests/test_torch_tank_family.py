"""The tank family's modules of koopmanx_torch against the JAX package:
the tank, tank3 and pendulum plants (clamps included), the RBF lift in
all six kinds, the state-augmented and zero-offset wrappers, the ``.mat``
weight loader, the du augmentation, the du control solve with the applied
window folded into du_0's bounds, and the shipped presets built on the
CPU. float64; inputs from numpy with a seed."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control.condensed import augment_delta_u as j_augment  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine import ref as jref  # noqa: E402
from koopmanx.lifts import base as jbase  # noqa: E402
from koopmanx.lifts.io import load_mat_mlp as j_load_mat_mlp  # noqa: E402
from koopmanx.lifts.mlp import encoder_dictionary as j_encoder  # noqa: E402
from koopmanx.lifts.rbf import rbf_dictionary as j_rbf  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import base as jsys  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control.condensed import augment_delta_u as t_augment  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine import ref as tref  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.lifts import base as tbase  # noqa: E402
from koopmanx_torch.lifts.io import load_mat_mlp as t_load_mat_mlp  # noqa: E402
from koopmanx_torch.lifts.mlp import MLP, encoder_dictionary as t_encoder  # noqa: E402
from koopmanx_torch.lifts.rbf import KINDS, rbf_dictionary as t_rbf  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate, resolve_weights_path  # noqa: E402
from koopmanx_torch.systems import base as tsys  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "duffing_kmae_encoder.mat")
NOMINAL = {"tank": [0.5, 0.4, 0.2, 0.3],
           "tank3": [0.5, 0.4, 0.2, 0.3, 0.2, 0.25],
           "pendulum": [4.0, 0.5, 1.0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["tank", "tank3", "pendulum"])
def test_plant_step_matches_jax(name):
    """One step of each plant at per-scenario parameters: the tanks' exact
    maps from levels at, below and above 0, clamped to x >= 0, with inputs
    that drain a tank; the pendulum by RK4. The same elementwise operations
    in both packages: 1e-12."""
    rng = np.random.default_rng(len(name))
    jsystem, tsystem = jlib.get_system(name), tlib.get_system(name)
    b, n = 32, jsystem.n
    x = rng.uniform(-0.5, 2.0, size=(b, n))
    x[0] = 0.0
    u = rng.uniform(-5.0, 5.0, size=(b, 1))
    th = np.array(NOMINAL[name]) * (1 + rng.uniform(-.15, .15, (b, len(NOMINAL[name]))))
    jstep = jsys.make_step(jsystem, 0.05)
    ref = np.asarray(jax.vmap(lambda xx, uu, t: jstep(
        xx, uu, type(jsystem.theta0)(*t)))(*(jnp.asarray(v) for v in (x, u, th))))
    tstep = tsys.make_step(tsystem, 0.05)
    out = tstep(torch.tensor(x), torch.tensor(u),
                type(tsystem.theta0)(*torch.tensor(th).T)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    if tsystem.discrete:
        assert out.min() >= 0.0 and (out == 0.0).any()  # clamped
    assert tsystem.theta0 == type(tsystem.theta0)(*jsystem.theta0)
    assert tsystem.theta1 == type(tsystem.theta1)(*jsystem.theta1)


def test_unported_integrator_raises():
    """Both integrators of the JAX package build (the MATLAB RK4 since the
    Revise_2 slice, ``tests/test_torch_dare.py``); a name neither package
    has raises."""
    for name in ("rk4", "rk4_matlab"):
        assert callable(tsys.make_step(tlib.DUFFING, 0.05, name))
    with pytest.raises(ValueError, match="unknown integrator"):
        tsys.make_step(tlib.DUFFING, 0.05, "euler")


def _points(centers, rng):
    """Points in the centers' box, one on a center (r^2 = 0)."""
    x = rng.uniform(-0.5, 1.5, size=(16, centers.shape[1]))
    x[3] = centers[2]
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_rbf_kinds_match_jax(kind):
    """Every kind on points including a center: the r^2 > 0 guard of
    thinplate and polyharmonic gives 0 there, in both packages."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(0.0, 1.0, size=(10, 2))
    x = _points(centers, rng)
    ref = np.asarray(j_rbf(jnp.asarray(centers), kind, eps=0.7, k=3)(
        jnp.asarray(x)))
    out = t_rbf(torch.tensor(centers), kind, eps=0.7, k=3)(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    assert np.isfinite(out.numpy()).all()
    if kind in ("thinplate", "polyharmonic"):
        assert out[3, 2] == 0.0


def test_rbf_unknown_kind_raises():
    with pytest.raises(ValueError, match="not recognized"):
        t_rbf(torch.zeros(3, 2), "cubic")


def _mlp_pair(rng):
    sizes = (2, 6, 6, 4)
    params = [(rng.normal(size=(o, i)) / np.sqrt(i), rng.normal(size=o))
              for i, o in zip(sizes[:-1], sizes[1:])]
    jd = j_encoder([(jnp.asarray(w), jnp.asarray(b)) for w, b in params], n=2)
    td = t_encoder(MLP.from_params([(torch.tensor(w), torch.tensor(b))
                                    for w, b in params]), n=2)
    return jd, td


def _rbf_pair(rng):
    centers = rng.uniform(0.0, 1.0, size=(5, 2))
    return j_rbf(jnp.asarray(centers)), t_rbf(torch.tensor(centers))


@pytest.mark.parametrize("inner", ["mlp", "rbf"])
@pytest.mark.parametrize("wrap", ["state_augmented", "state_augmented_zero",
                                  "zero_offset"])
def test_lift_wrappers_match_jax(inner, wrap):
    """``state_augmented`` (with and without the zero offset: the port
    writes JAX's ``zero_offset=True`` as ``state_augmented(zero_offset(d))``)
    and ``zero_offset`` over an MLP and over an RBF, then ``normalized`` on
    top as ``build_dictionary`` composes them: 1e-12."""
    rng = np.random.default_rng(5)
    jd, td = (_mlp_pair if inner == "mlp" else _rbf_pair)(rng)
    if wrap == "zero_offset":
        jd, td = jbase.zero_offset(jd), tbase.zero_offset(td)
    elif wrap == "state_augmented_zero":
        jd = jbase.state_augmented(jd, zero_offset=True)
        td = tbase.state_augmented(tbase.zero_offset(td))
    else:
        jd, td = jbase.state_augmented(jd), tbase.state_augmented(td)
    assert td.nlift == jd.nlift and td.n == jd.n
    train = rng.uniform(-1.0, 2.0, size=(40, 2))
    jmu, jsc = jbase.fit_normalizer(jd, jnp.asarray(train))
    with torch.no_grad():
        tmu, tsc = tbase.fit_normalizer(td, torch.tensor(train))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0, atol=1e-12)
    jn, tn = jbase.normalized(jd, jmu, jsc), tbase.normalized(td, tmu, tsc)
    x = rng.uniform(-1.0, 2.0, size=(12, 2))
    x[0] = 0.0
    with torch.no_grad():
        for j, t in ((jd, td), (jn, tn)):
            np.testing.assert_allclose(t(torch.tensor(x)).numpy(),
                                       np.asarray(j(jnp.asarray(x))),
                                       rtol=0, atol=1e-12)
        if wrap != "state_augmented":  # the offset: psi(0) = 0
            assert np.abs(td(torch.zeros(1, 2, dtype=F64)).numpy()).max() == 0.0


@pytest.mark.parametrize("flags", [(True, False), (False, True), (True, True)],
                         ids=["state_augmented", "zero_offset", "both"])
def test_lift_wrappers_round_trip_through_convert(flags):
    """The wrappers' flags cross ``pipeline_to_numpy`` and back: the same
    flags, centers and normalizer, and the rebuilt lift equals the first
    bit for bit, a center (r^2 = 0) and the origin among the points."""
    aug, zo = flags
    rng = np.random.default_rng(9)
    n, k = 2, 5
    nlift = k + n * aug
    cfg = TC.pendulum_preset()
    cfg.lift.state_augmented, cfg.lift.zero_offset = aug, zo
    arrays = {
        "rbf": {"centers": rng.uniform(0, 1, (k, n)), "kind": "thinplate"},
        "state_augmented": aug, "zero_offset": zo,
        "normalizer": (rng.normal(size=nlift), rng.uniform(1, 2, nlift)),
        "model0": (np.eye(nlift), np.ones((nlift, 1)), np.ones((n, nlift))),
        "rls0": {"zx": np.zeros((4, nlift)), "u": np.zeros((4, 1)),
                 "zy": np.zeros((4, nlift)), "x": np.zeros((4, n)),
                 "idx": np.zeros((), np.int32)},
        "params": {"q_block": np.eye(1), "r_block": np.eye(1),
                   "u_min": [-6.0], "u_max": [6.0]},
    }
    pipe = pipeline_from_numpy(arrays, cfg, device="cpu", dtype=F64)
    back = pipeline_to_numpy(pipe)
    assert back.get("state_augmented", False) == aug
    assert back.get("zero_offset", False) == zo
    np.testing.assert_array_equal(back["rbf"]["centers"],
                                  arrays["rbf"]["centers"])
    for a, b in zip(back["normalizer"], arrays["normalizer"]):
        np.testing.assert_array_equal(a, b)
    again = pipeline_from_numpy(back, cfg, device="cpu", dtype=F64)
    x = np.concatenate([arrays["rbf"]["centers"][:1], np.zeros((1, n)),
                        rng.uniform(-1, 2, (6, n))])
    with torch.no_grad():
        z, z2 = (p.dictionary(torch.tensor(x)) for p in (pipe, again))
    assert z.shape == (8, nlift)
    np.testing.assert_array_equal(z.numpy(), z2.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_load_mat_mlp_matches_jax(dtype):
    """The in-repo encoder, 2-100-100-100-8: the same numbers (both read
    through float64 and cast)."""
    jp = j_load_mat_mlp(ARTIFACT, dtype=getattr(jnp, dtype))
    tp = t_load_mat_mlp(ARTIFACT, dtype=getattr(torch, dtype))
    assert [tuple(w.shape) for w, _ in tp] == [(100, 2), (100, 100),
                                                (100, 100), (8, 100)]
    for (tw, tb), (jw, jb) in zip(tp, jp):
        assert tw.dtype == getattr(torch, dtype) and tb.dim() == 1
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_augment_delta_u_matches_jax():
    rng = np.random.default_rng(9)
    b, nz, m, p = 3, 5, 2, 2
    model = [rng.normal(size=s) for s in ((b, nz, nz), (b, nz, m), (b, p, nz))]
    ref = jax.vmap(lambda a, bb, c: j_augment(JModel(a, bb, c)))(
        *(jnp.asarray(v) for v in model))
    out = t_augment(TModel(*(torch.tensor(v) for v in model)))
    for t, j in zip(out, ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(out.A.shape) == (b, nz + m, nz + m)


@pytest.mark.parametrize("dither", [0.0, 0.3])
def test_delta_u_control_solve_matches_jax(dither):
    """The du control solve over scenarios whose previous inputs sit
    inside, at and near the edges of the applied window [-8, 8], so that
    the folded first bounds differ per scenario and are tighter than the
    du box where u_prev is within 0.5 of an edge; with and without the
    dither probe. The kernel route (its plain version on CPU tensors):
    u and the warm start to 1e-9."""
    rng = np.random.default_rng(13)
    b, nz, m, horizon, step = 5, 4, 1, 10, 7
    a = 0.9 * np.eye(nz) + 0.05 * rng.normal(size=(b, nz, nz))
    bb = 0.3 * rng.normal(size=(b, nz, m))
    c = rng.normal(size=(b, 2, nz))
    z = rng.normal(size=(b, nz))
    u_prev = np.array([[0.0], [7.8], [-7.9], [8.0], [3.0]])
    warm = 0.1 * rng.normal(size=(b, horizon * m))
    kw = dict(horizon=horizon, delta_u=True, qp_backend="pallas",
              qp_kkt_block=4, dither=dither, update="off")
    params = dict(q_block=10.0 * np.eye(1), r_block=1e-3 * np.eye(1),
                  u_min=[-0.5], u_max=[0.5], cy=np.array([[0.0, 1.0]]),
                  applied_min=[-8.0], applied_max=[8.0])
    jcfg = jcore.EngineConfig(**kw)
    jsolve = jcore.make_control_solver(
        None, jcfg, jref.constant(jnp.ones(1), horizon, 1, jnp.float64), m)
    jp = jcore.MPCParams(**{k: jnp.asarray(v, jnp.float64)
                            for k, v in params.items()})
    jdec = jax.vmap(lambda mdl, zz, up, wx: jsolve(
        jp, mdl, (), None, zz, up, wx, (), jnp.asarray(step)))(
        JModel(*(jnp.asarray(v) for v in (a, bb, c))), jnp.asarray(z),
        jnp.asarray(u_prev), jnp.asarray(warm))
    tsolve = tcore.make_control_solver(
        tcore.EngineConfig(**kw),
        tref.constant(torch.ones(1, dtype=F64), horizon, 1, F64), m)
    tp = replicate(tcore.MPCParams(**{k: torch.tensor(np.asarray(v, float))
                                      for k, v in params.items()}), b)
    tdec = tsolve(tp, TModel(*(torch.tensor(v) for v in (a, bb, c))),
                  torch.tensor(z), torch.tensor(u_prev), torch.tensor(warm),
                  (), step)
    u = tdec.u_applied.numpy()
    np.testing.assert_allclose(u, np.asarray(jdec.u_applied), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tdec.warm_x.numpy(), np.asarray(jdec.warm_x),
                               rtol=0, atol=1e-9)
    assert np.abs(u).max() <= 8.0 and np.abs(u - u_prev).max() <= 0.5 + 1e-12


def test_weights_path_falls_back_to_the_in_repo_artifact():
    """A missing weights file falls back to
    ``artifacts/<system>_kmae_encoder.mat`` under the repo root, whatever
    the working directory, else to a random init (None), as
    ``koopmanx/run.py:65-75`` does."""
    assert resolve_weights_path("no/such/weights.mat", "duffing") == ARTIFACT
    assert resolve_weights_path(ARTIFACT, "tank") == ARTIFACT
    assert resolve_weights_path("no/such/weights.mat", "tank") is None
    assert resolve_weights_path(None, "duffing") is None


def _small(cfg, data_cls):
    cfg.dtype = "float64"
    cfg.steps = 6
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    return cfg


@pytest.mark.parametrize("name", ["duffing", "pendulum"])
def test_shipped_preset_builds_and_its_dictionary_matches_jax(name):
    """The preset as shipped (20x20 data, 6 steps) builds on the CPU and
    runs; its lift is JAX's on the same weights: the duffing encoder from
    the ``.mat`` file the port resolves (the in-repo artifact unless the
    repo holds the reference's file), and for pendulum JAX's random centers
    and each normalizer carried across."""
    jcfg = _small(JC.PRESETS[name](), JC.DataConfig)
    tcfg = _small(TC.PRESETS[name](), TC.DataConfig)
    if name == "duffing":  # JAX reads the file the port resolved
        jcfg.lift.weights_path = resolve_weights_path(
            tcfg.lift.weights_path, "duffing")
    pipe = t_build_pipeline(tcfg, device="cpu")
    b = 3
    x0 = torch.tensor(np.random.default_rng(2).uniform(-2, 2, (b, 2)))
    carry, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, b), x0,
                             replicate(pipe.model0, b), replicate(pipe.rls0, b))
    assert log.x.shape == (b, 6, 2) and torch.isfinite(log.x).all()
    bound = tcfg.mpc.u_max
    assert float(log.u.abs().max()) <= bound
    jpipe = j_build_pipeline(jcfg)
    inner, mu, sc = jpipe.dictionary.params
    arrays = {"normalizer": (np.asarray(mu), np.asarray(sc)),
              "model0": tuple(np.asarray(v) for v in jpipe.model0),
              "params": {k: np.asarray(getattr(jpipe.params, k))
                         for k in ("q_block", "r_block", "u_min", "u_max")}}
    if name == "duffing":
        tw = [(w.detach().numpy(), bb.detach().numpy())
              for w, bb in pipe.dictionary.encoder.params()]
        for (w, bb), (jw, jb) in zip(tw, inner):
            np.testing.assert_array_equal(w, np.asarray(jw))
            np.testing.assert_array_equal(bb, np.asarray(jb))
        arrays["mlp"] = tw
        arrays["rls0"] = {k: np.asarray(v)
                          for k, v in jpipe.rls0._asdict().items()}
    else:
        assert pipe.dictionary.nlift == jpipe.dictionary.nlift == 14
        arrays["rbf"] = {"centers": np.asarray(inner), "kind": "thinplate"}
        arrays["state_augmented"] = True
        arrays["rls0"] = {k: np.asarray(getattr(jpipe.rls0, k))
                          for k in ("zx", "u", "zy", "x", "idx")}
    conv = pipeline_from_numpy(arrays, tcfg, device="cpu", dtype=F64)
    x = np.random.default_rng(3).uniform(-2, 2, (10, 2))
    with torch.no_grad():
        z = conv.dictionary(torch.tensor(x)).numpy()
    np.testing.assert_allclose(z, np.asarray(jpipe.dictionary(jnp.asarray(x))),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(conv.x_init.numpy(), [-2.0, -2.0])


@pytest.mark.parametrize("name", ["tank", "tank3"])
def test_tank_presets_build_and_run_on_cpu(name):
    """The tank presets as shipped (20x20 data, 6 steps): a prefilled
    window of 256, a start at x = 0, the du box and the applied window
    held, x >= 0; the tracked output is the last-but-one (tank) or last
    (tank3) level."""
    cfg = _small(TC.PRESETS[name](), TC.DataConfig)
    pipe = t_build_pipeline(cfg, device="cpu")
    n = tlib.get_system(name).n
    assert pipe.rls0.zx.shape == (256, pipe.dictionary.nlift)
    assert int(pipe.rls0.idx) == 0 and pipe.x_init.tolist() == [0.0] * n
    assert pipe.params.cy.tolist() == [[float(i == cfg.mpc.cy_index)
                                        for i in range(n)]]
    assert pipe.params.applied_max.tolist() == [8.0]
    b = 3
    x0 = torch.tensor(np.random.default_rng(4).uniform(0, 2, (b, n)))
    carry, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, b), x0,
                             replicate(pipe.model0, b), replicate(pipe.rls0, b))
    u = torch.cat([torch.zeros(b, 1, 1, dtype=F64), log.u], dim=1)
    assert float((u[:, 1:] - u[:, :-1]).abs().max()) <= 0.5 + 1e-12
    assert float(log.u.abs().max()) <= 8.0 and float(log.x.min()) >= 0.0
    assert carry.rls.idx.tolist() == [6] * b
