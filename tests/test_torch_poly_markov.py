"""koopmanx_torch's polynomial and identity lifts (``lifts/poly.py``,
``lifts/base.py::identity_dictionary``) and the log-depth Markov builds
(``control/condensed.py::markov_doubling``, ``markov_assoc``) against the
JAX package, on numpy inputs made from a seed, in float64; then one
closed loop per new lift kind and per new build against JAX
``run_batch`` (the pipeline carried across with
``convert.pipeline_from_numpy``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control import condensed as jcond  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.lifts import base as jlb  # noqa: E402
from koopmanx.lifts import poly as jpoly  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control import condensed as tcond  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.lifts import base as tlb  # noqa: E402
from koopmanx_torch.lifts import poly as tpoly  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
BATCH, STEPS = 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("quirk", [False, True])
def test_hermite_dictionary_matches_jax(quirk):
    """The 25 tensor-product Hermite features, standard and the
    reference's H0 = 2x + 2, and the sequence itself: 1e-12 of
    max(1, |value|) (polynomials up to degree 8 over [-3, 3]^2)."""
    x = np.random.default_rng(0).uniform(-3, 3, (64, 2))
    jd = jpoly.hermite_dictionary(reference_quirk=quirk)
    td = tpoly.hermite_dictionary(reference_quirk=quirk)
    assert td.nlift == jd.nlift == 25 and td.n == 2
    want = np.asarray(jd(jnp.asarray(x)))
    got = td(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (64, 25)
    assert (np.abs(got - want) <= 1e-12 * np.maximum(1, np.abs(want))).all()
    for a, b in zip(tpoly.hermite_sequence(torch.tensor(x[:, 0]), 6, quirk),
                    jpoly.hermite_sequence(jnp.asarray(x[:, 0]), 6, quirk)):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) <= 1e-12 * np.maximum(1, np.abs(b))).all()


@pytest.mark.parametrize("kind", ["monomial", "identity"])
def test_monomial_and_identity_match_jax(kind):
    x = np.random.default_rng(1).uniform(-3, 3, (64, 2))
    jd = (jpoly.monomial_dictionary() if kind == "monomial"
          else jlb.identity_dictionary(2))
    td = (tpoly.monomial_dictionary() if kind == "monomial"
          else tlb.identity_dictionary(2))
    assert td.nlift == jd.nlift and td.n == jd.n == 2
    np.testing.assert_allclose(td(torch.tensor(x)).numpy(),
                               np.asarray(jd(jnp.asarray(x))), rtol=1e-12,
                               atol=1e-12)


def _models(rng, batch, nz, m, py):
    a = rng.normal(size=(batch, nz, nz)) * 0.3 + 0.5 * np.eye(nz)
    b = rng.normal(size=(batch, nz, m))
    c = rng.normal(size=(batch, py, nz))
    return a, b, c


@pytest.mark.parametrize("method", ["doubling", "assoc"])
@pytest.mark.parametrize("horizon", [1, 5, 8, 13, 20])
def test_markov_builds_match_jax_and_dag(method, horizon):
    """F1 and F2 of 3 random models (nz = 8, m = 2, py = 3, spectral
    radius ~1) against JAX's build of the same name per scenario and
    against the port's 'dag': 1e-10 of max(1, |F|)."""
    rng = np.random.default_rng(horizon)
    a, b, c = _models(rng, 3, 8, 2, 3)
    got = tcond.prediction_matrices(
        TModel(*(torch.tensor(v) for v in (a, b, c))), horizon, method=method)
    dag = tcond.prediction_matrices(
        TModel(*(torch.tensor(v) for v in (a, b, c))), horizon, method="dag")
    for i in range(3):
        want = jcond.prediction_matrices(
            JModel(*(jnp.asarray(v[i]) for v in (a, b, c))), horizon,
            method=method)
        for t, d, j in zip(got, dag, want):
            j = np.asarray(j)
            assert t[i].shape == j.shape
            scale = np.maximum(1.0, np.abs(j))
            assert (np.abs(t[i].numpy() - j) <= 1e-10 * scale).all()
            assert (np.abs(t[i].numpy() - d[i].numpy()) <= 1e-10 * scale).all()


def test_unknown_markov_build_raises():
    a, b, c = (torch.tensor(v) for v in _models(np.random.default_rng(0), 1,
                                                  4, 1, 2))
    with pytest.raises(ValueError, match="markov method"):
        tcond.prediction_matrices(TModel(a, b, c), 5, method="lu")


def _configure(cfg, lift_cls, kind, markov):
    """The duffing preset at test size: 16 steps with the switch at 8,
    horizon 10, 20x20 data, float64, the kernel route (CPU tensors take
    its plain version); the lift ``kind`` (an MLP of width 16 for the
    Markov builds, the Hermite lift normalized, the others not)."""
    cfg.steps, cfg.dtype, cfg.switch_step = STEPS, "float64", STEPS // 2
    cfg.mpc.horizon, cfg.mpc.qp_backend = 10, "pallas"
    cfg.mpc.markov = markov
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    cfg.lift = lift_cls(kind=kind, nlift=8, hidden=16,
                        normalize=kind == "hermite")
    return cfg


def _arrays_from_jax(pipe):
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    lc = pipe.config.lift
    params = n(pipe.dictionary.params)
    inner, norm = (params[0], params[1:]) if lc.normalize else (params, None)
    base = {"mlp": {"mlp": [tuple(layer) for layer in inner or ()]},
            "hermite": {"hermite": {"degree": 4, "reference_quirk": False}},
            "monomial": {"monomial": True},
            "identity": {"identity": True}}[lc.kind]
    p = pipe.params
    return {**base, "normalizer": norm, "model0": tuple(n(pipe.model0)),
            "rls0": n(pipe.rls0._asdict()),
            "params": {"q_block": n(p.q_block), "r_block": n(p.r_block),
                       "u_min": n(p.u_min), "u_max": n(p.u_max),
                       "cy": None, "ref_state": n(p.ref_state)},
            "x_init": n(pipe.x_init)}


@pytest.mark.parametrize("kind,markov", [
    ("hermite", "dag"), ("monomial", "dag"), ("identity", "dag"),
    ("mlp", "doubling"), ("mlp", "assoc"),
])
def test_loop_matches_jax_run_batch(kind, markov):
    """4 Duffing scenarios x 16 float64 steps through the switch at 8 on
    the pipeline JAX builds, carried across: x and u within 1e-9 of JAX
    ``run_batch`` in every scenario and step or, where it is larger,
    within ten times JAX's own divergence from one ulp of x0 (up or down)
    up to that step, as tests/test_torch_vdp.py holds its loops: from a
    scratch RLS prior and bang-bang inputs the reference's own loop
    amplifies round-off (the Hermite lift's features reach ~1e3); |u| <=
    2. The port's own build of the same config runs too (finite, nlift as
    the lift gives it)."""
    jcfg = _configure(JC.duffing_nn_preset(), JC.LiftConfig, kind, markov)
    tcfg = _configure(TC.duffing_nn_preset(), TC.LiftConfig, kind, markov)
    jpipe = j_build_pipeline(jcfg)
    arrays = _arrays_from_jax(jpipe)
    pipe = pipeline_from_numpy(arrays, tcfg, device="cpu", dtype=F64)
    assert pipe.dictionary.nlift == jpipe.dictionary.nlift
    back = pipeline_to_numpy(pipe)
    assert {k: back.get(k) for k in ("hermite", "monomial", "identity")} == {
        k: arrays.get(k) for k in ("hermite", "monomial", "identity")}
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2, 2, (BATCH, 2))
    th0 = np.array([-0.5, 1.0, -1.0]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    th1 = np.array([-5.0, 2.0, -0.5]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    jrun = jax.jit(lambda x: j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params), x,
        jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        JDuffing(*jnp.asarray(th0.T)), JDuffing(*jnp.asarray(th1.T)))[1])
    jlog, *jfloors = (jrun(jnp.asarray(x)) for x in (
        x0, np.nextafter(x0, 9.0), np.nextafter(x0, -9.0)))
    _, tlog = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
        TDuffing(*torch.tensor(th0.T)), TDuffing(*torch.tensor(th1.T)))
    for key in ("x", "u"):
        got, want = getattr(tlog, key).numpy(), np.asarray(getattr(jlog, key))
        assert got.shape == want.shape and np.isfinite(got).all()
        diff = np.abs(got - want).max(-1)  # (B, T)
        floor = np.maximum.accumulate(np.max(
            [np.abs(np.asarray(getattr(f, key)) - want).max(-1)
             for f in jfloors], axis=0), axis=1)
        assert (diff <= np.maximum(1e-9, 10 * floor)).all(), (
            key, diff.max(), floor.max())
    assert np.abs(tlog.u.numpy()).max() <= 2.0
    own = t_build_pipeline(tcfg, device="cpu")
    assert own.dictionary.nlift == pipe.dictionary.nlift
    _, log = t_run_batch(own.closed_loop, replicate(own.params, 2),
                         torch.tensor(x0[:2]), replicate(own.model0, 2),
                         replicate(own.rls0, 2))
    assert torch.isfinite(log.x).all() and log.u.abs().max() <= 2.0
