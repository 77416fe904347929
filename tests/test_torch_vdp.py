"""The Van der Pol slice of koopmanx_torch against the JAX package: the
plant, the reference generators (the lifted one through the normalized
MLP lift of the shipped encoder), the VDP presets and bench configs, and
the batched closed loop under lifted-space tracking, output tracking and
the time-varying references, against JAX ``run_batch``. float64 on the
CPU; inputs from numpy with a seed."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.engine import ref as jref  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.lifts import base as jbase  # noqa: E402
from koopmanx.lifts.io import load_mat_mlp as j_load_mat_mlp  # noqa: E402
from koopmanx.lifts.mlp import encoder_dictionary as j_encoder  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import base as jsys  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine import ref as tref  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.lifts import base as tbase  # noqa: E402
from koopmanx_torch.lifts.io import load_mat_mlp as t_load_mat_mlp  # noqa: E402
from koopmanx_torch.lifts.mlp import MLP  # noqa: E402
from koopmanx_torch.lifts.mlp import encoder_dictionary as t_encoder  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import (  # noqa: E402
    REPO_ROOT,
    ref_fn_for,
    replicate,
    resolve_weights_path,
)
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.systems import base as tsys  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

F64 = torch.float64
BATCH, STEPS, HORIZON = 4, 16, 10
NOMINAL = [2.0, 2.0, -10.0, -0.8]
SWITCHED = [1.0, -3.0, -10.0, -3.0]
ENCODER = os.path.join(REPO_ROOT, "artifacts", "vanderpol_kmae_encoder.mat")
PARAM_KEYS = ("q_block", "r_block", "u_min", "u_max", "cy", "applied_min",
              "applied_max", "terminal", "q_lift", "x_min", "x_max",
              "ref_state")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("switched", [False, True], ids=["theta0", "theta1"])
def test_vdp_field_and_rk4_step_match_jax(switched):
    """The vector field and one RK4 step at per-scenario parameters within
    15 % of the nominal (or switched) values, states in [-3, 3]^2 and
    inputs in [-6, 6]: the same elementwise operations, 1e-12."""
    rng = np.random.default_rng(5 + switched)
    b = 32
    x = rng.uniform(-3.0, 3.0, size=(b, 2))
    u = rng.uniform(-6.0, 6.0, size=(b, 1))
    th = np.array(SWITCHED if switched else NOMINAL)
    th = th * (1 + rng.uniform(-.15, .15, (b, 4)))
    jx, ju, jth = (jnp.asarray(v) for v in (x, u, th))
    jf = np.asarray(jax.vmap(lambda xx, uu, t: jlib.VANDERPOL.f(
        0.0, xx, uu, jlib.VdpParams(*t)))(jx, ju, jth))
    jstep = jsys.make_step(jlib.VANDERPOL, 0.05)
    js = np.asarray(jax.vmap(lambda xx, uu, t: jstep(
        xx, uu, jlib.VdpParams(*t)))(jx, ju, jth))
    tx, tu, tth = torch.tensor(x), torch.tensor(u), tlib.VdpParams(
        *torch.tensor(th).T)
    tf = tlib.VANDERPOL.f(0.0, tx, tu, tth).numpy()
    ts = tsys.make_step(tlib.VANDERPOL, 0.05)(tx, tu, tth).numpy()
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-12 * np.abs(jf).max())
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-12)
    assert tlib.get_system("vanderpol") is tlib.VANDERPOL
    for name in ("theta0", "theta1"):
        assert getattr(tlib.VANDERPOL, name) == tlib.VdpParams(
            *getattr(jlib.VANDERPOL, name))


def test_sample_scenarios_perturbs_every_vdp_parameter():
    """All four fields of both parameter sets are drawn per scenario,
    within param_scale of the nominal value, and differ between
    scenarios."""
    sc = sample_scenarios(tlib.VANDERPOL, torch.Generator().manual_seed(3),
                          256, param_scale=0.15, dtype=F64, device="cpu")
    for theta, nominal in ((sc.theta0, NOMINAL), (sc.theta1, SWITCHED)):
        assert type(theta) is tlib.VdpParams
        for leaf, nom in zip(theta, nominal):
            ratio = leaf.numpy() / nom
            assert leaf.shape == (256,)
            assert np.abs(ratio - 1).max() <= 0.15 and ratio.std() > 0.05


def _window_gens(module, py, dtype, extra=None):
    """Each generator the JAX package's ``_ref_fn`` builds, with its
    arguments (``koopmanx/run.py:254-280``)."""
    kw = dict(dtype=dtype, **(extra or {}))
    return {
        "constant": module.constant(0.7, HORIZON, py, **kw),
        "sine": module.sine(0.9, 0.01, HORIZON, py, **kw),
        "square": module.square(1.1, 200, HORIZON, py, **kw),
        "chirp": module.chirp(0.8, HORIZON, py, **kw),
        "cos_sin_mix": module.cos_sin_mix(0.5, 0.007, 1.2, 0.002, HORIZON,
                                          py, **kw),
        "constant_state": module.constant_state([1.0, -0.3], HORIZON, **kw),
    }


@pytest.mark.parametrize("step", [0, 7, 199, 200])
@pytest.mark.parametrize("name", ["constant", "sine", "square", "chirp",
                                  "cos_sin_mix", "constant_state"])
def test_reference_generator_matches_jax(name, step):
    """The window at ``step`` (199 and 200 straddle the square wave's
    sign change at j = 200), 3 channels, float64: 1e-12."""
    jw = np.asarray(_window_gens(jref, 3, jnp.float64)[name](
        jnp.asarray(step)))
    tw = _window_gens(tref, 3, F64, {"device": "cpu"})[name](step).numpy()
    assert tw.shape == jw.shape == (HORIZON, 2 if name == "constant_state"
                                    else 3)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-12)
    if name == "square":
        assert set(np.unique(tw[:, 0])) <= {-1.1, 1.1}


def test_encoded_reference_lifts_the_state_window_like_jax():
    """``encoded`` through the normalized MLP lift of the shipped VDP
    encoder (normalizer fit on the same seeded states in both packages):
    the constant state reference [1, 0] and a window whose rows all
    differ become (horizon, nlift) windows, each row the lift of its
    state row, 1e-12 from JAX."""
    rng = np.random.default_rng(9)
    train = rng.uniform(-2.0, 2.0, size=(200, 2))
    jd = j_encoder(j_load_mat_mlp(ENCODER, dtype=jnp.float64), n=2)
    jd = jbase.normalized(jd, *jbase.fit_normalizer(jd, jnp.asarray(train)))
    td = t_encoder(MLP.from_params(t_load_mat_mlp(ENCODER, F64)), n=2)
    with torch.no_grad():
        td = tbase.normalized(td, *tbase.fit_normalizer(
            td, torch.tensor(train)))
        window = rng.uniform(-2.0, 2.0, size=(HORIZON, 2))
        for jbase_fn, tbase_fn, states in (
                (jref.constant_state([1.0, 0.0], HORIZON, jnp.float64),
                 tref.constant_state([1.0, 0.0], HORIZON, F64),
                 np.tile([1.0, 0.0], (HORIZON, 1))),
                (lambda s: jnp.asarray(window), lambda s: torch.tensor(window),
                 window)):
            jr = np.asarray(jref.encoded(jbase_fn, jd, 2)(jnp.asarray(4)))
            tr = tref.encoded(tbase_fn, td, 2)(4).numpy()
            assert tr.shape == (HORIZON, td.nlift)
            np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-12)
            np.testing.assert_array_equal(
                tr, td(torch.tensor(states)).numpy())


def _jax_bench(name, steps=200):
    """JAX's preset with ``bench.py``'s overrides (``bench.py:52-113``)."""
    cfg = JC.PRESETS[name]()
    cfg.steps, cfg.dtype, cfg.switch_step = steps, "float32", steps // 2
    cfg.mpc.horizon, cfg.mpc.qp_backend = 20, "pallas"
    cfg.data = dataclasses.replace(cfg.data, n_step=50, n_traj=50)
    return cfg


CONFIGS = {
    "vanderpol": (TC.vdp_lifted_preset, JC.vdp_lifted_preset),
    "vanderpol_selftrained": (TC.vanderpol_selftrained_preset,
                              JC.vanderpol_selftrained_preset),
    "vanderpol_rbf": (TC.vanderpol_rbf_preset, JC.vanderpol_rbf_preset),
    "vdp_bench": (TC.vdp_bench_config, lambda: _jax_bench("vanderpol")),
    "vdp_rbf_bench": (TC.vdp_rbf_bench_config,
                      lambda: _jax_bench("vanderpol_rbf")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vdp_configs_match_jax(name):
    """Field for field against the JAX package's presets (the bench
    configs against the preset with ``bench.py``'s overrides); the
    weights resolve to the same file as JAX's (the in-repo artifact
    unless the repo holds the reference's)."""
    tcfg, jcfg = CONFIGS[name]
    t, j = tcfg(), jcfg()
    assert name not in TC.PRESETS or TC.PRESETS[name] is tcfg
    for part in ("data", "lift", "mpc", "update"):
        td, jd = (dataclasses.asdict(getattr(c, part)) for c in (t, j))
        jd = {k: v for k, v in jd.items() if k in td}
        tpath, jpath = td.pop("weights_path", None), jd.pop("weights_path",
                                                            None)
        assert td == jd, part
        if tpath is not None:
            assert (resolve_weights_path(tpath, t.system)
                    == _jax_resolved(jpath, j.system))
    for k in ("system", "steps", "switch_step", "reference", "dtype", "seed"):
        assert getattr(t, k) == getattr(j, k), k


def _jax_resolved(path, system):
    """The file JAX's ``build_dictionary`` loads (``koopmanx/run.py:65-75``)."""
    if os.path.exists(path):
        return path
    alt = os.path.join(REPO_ROOT, "artifacts", f"{system}_kmae_encoder.mat")
    return alt if os.path.exists(alt) else None


@pytest.mark.parametrize("name", ["vanderpol", "vanderpol_selftrained"])
def test_vdp_preset_builds_with_the_shipped_encoder(name):
    """The preset builds on the CPU (20x20 data, 6 steps) from the
    encoder JAX loads, bit for bit; under lifted tracking the output
    weight is nlift x nlift and the logged reference head is the lifted
    [1, 0], nlift wide; output tracking logs the state reference."""
    cfg = TC.PRESETS[name]()
    cfg.steps, cfg.dtype = 6, "float64"
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    path = resolve_weights_path(cfg.lift.weights_path, "vanderpol")
    assert os.path.basename(path) == (
        "vanderpol_kmae_encoder.mat" if name == "vanderpol"
        else "vanderpol_kmae_refscale_encoder.mat")
    pipe = t_build_pipeline(cfg, device="cpu")
    for (w, b), (jw, jb) in zip(pipe.dictionary.encoder.params(),
                                j_load_mat_mlp(path, dtype=jnp.float64)):
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))
    nlift, lifted = pipe.dictionary.nlift, cfg.mpc.track_lifted
    py = nlift if lifted else 2
    assert pipe.params.q_block.shape == (py, py) and pipe.params.cy is None
    b = 3
    x0 = torch.tensor(np.random.default_rng(2).uniform(-2, 2, (b, 2)))
    _, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, b), x0,
                         replicate(pipe.model0, b), replicate(pipe.rls0, b))
    assert log.r.shape == (b, 6, py) and torch.isfinite(log.x).all()
    with torch.no_grad():
        r = pipe.dictionary(torch.tensor([1.0, 0.0], dtype=F64)) if lifted \
            else torch.tensor([1.0, 0.0], dtype=F64)
    np.testing.assert_allclose(log.r[:, 0].numpy(),
                               np.broadcast_to(r.numpy(), (b, py)), rtol=0,
                               atol=1e-12)
    assert float(log.u.abs().max()) <= 6.0


def _configure(cfg, reference="constant"):
    """The preset at test size: 16 steps with the switch at 8, 20x20 data
    with the preset's ranges, f64, horizon 10, the kernel route (its plain
    version on CPU tensors; JAX's CPU fallback)."""
    cfg.steps = STEPS
    cfg.dtype = "float64"
    cfg.switch_step = STEPS // 2
    cfg.mpc.horizon = HORIZON
    cfg.mpc.qp_backend = "pallas"
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    cfg.reference = reference
    return cfg


def arrays_from_jax(pipe):
    """The JAX pipeline as ``convert.pipeline_from_numpy`` reads it: an MLP
    or RBF lift with its wrappers (state augmentation, zero offset) and
    normalizer, the estimator state by its fields, the MPC arrays."""
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    lc = pipe.config.lift
    params = n(pipe.dictionary.params)
    inner, norm = (params[0], params[1:]) if lc.normalize else (params, None)
    base = ({"mlp": [tuple(layer) for layer in inner]} if lc.kind == "mlp"
            else {"rbf": {"centers": inner, "kind": lc.rbf_type}})
    p = pipe.params
    return {
        **base,
        "state_augmented": lc.state_augmented,
        "zero_offset": lc.zero_offset,
        "normalizer": norm,
        "model0": tuple(n(pipe.model0)),
        "rls0": n(pipe.rls0._asdict()),
        "params": {k: None if getattr(p, k) is None else n(getattr(p, k))
                   for k in PARAM_KEYS},
        "x_init": n(pipe.x_init),
    }


VDP = (jlib.VdpParams, tlib.VdpParams, NOMINAL, SWITCHED)


def scenarios(nominal, switched, batch=BATCH, seed=0, n=2):
    """x0 ~ U[-2, 2]^n and per-scenario plant parameters within 15 % of
    the nominal and switched values."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2.0, 2.0, size=(batch, n))
    th0 = np.array(nominal) * (1 + rng.uniform(-.15, .15, (batch, len(nominal))))
    th1 = np.array(switched) * (1 + rng.uniform(-.15, .15,
                                                (batch, len(switched))))
    return x0, th0, th1


def run_both(jcfg, tcfg, plant=VDP, n=2, nudge_model=False):
    """The JAX pipeline of ``jcfg``, carried across into the port under
    ``tcfg``, both run over the same scenarios of ``plant`` (its parameter
    classes in both packages, nominal and switched values; an n-state
    plant), and JAX twice
    more with every x0 moved up, then down, by one ulp: the reference's
    own round-off floor on these scenarios. Returns the three JAX logs, the
    port's log, carry and pipeline. The port's run launches no kernel: its tensors
    are on the CPU. ``nudge_model`` adds a fourth JAX log from the initial
    model's A moved up by one ulp (the floor of what the first steps
    compute from the model alone, such as its DARE)."""
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    jp, tp, nominal, switched = plant
    x0, th0, th1 = scenarios(nominal, switched, n=n)
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    jrun = jax.jit(lambda x, model: j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params), x,
        jax.tree_util.tree_map(rep, model),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        jp(*jnp.asarray(th0.T)), jp(*jnp.asarray(th1.T)))[1])
    jlogs = tuple(jrun(jnp.asarray(x), jpipe.model0) for x in (
        x0, np.nextafter(x0, 9.0), np.nextafter(x0, -9.0)))
    if nudge_model:
        a_up = np.nextafter(np.asarray(jpipe.model0.A), 9.0)
        jlogs += (jrun(jnp.asarray(x0),
                       jpipe.model0._replace(A=jnp.asarray(a_up))),)
    launches = box_admm.launches
    carry, log = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, BATCH), torch.tensor(x0),
        replicate(pipe.model0, BATCH), replicate(pipe.rls0, BATCH),
        tp(*torch.tensor(th0.T)), tp(*torch.tensor(th1.T)))
    assert box_admm.launches == launches
    return jlogs, log, carry, pipe


def assert_logs_match(jlogs, log, x_tol=1e-9, u_tol=1e-8):
    """x to ``x_tol`` and u to ``u_tol`` in every scenario and step, or,
    where it is larger, to ten times the JAX package's own divergence from
    one ulp of x0 (up or down) in that scenario up to that step: from a
    scratch RLS, a reset Gram or a bang-bang input the reference's own
    loop amplifies round-off past the stated tolerance within 16 steps,
    and no port can be closer to it than it is to itself. The logged
    reference head to 1e-12. Returns the largest differences and floors."""
    jlog, *jfloors = jlogs
    tx, tu = log.x.numpy(), log.u.numpy()
    assert tx.shape == np.asarray(jlog.x).shape
    assert np.isfinite(tx).all() and np.isfinite(tu).all()
    out = {}
    for k, tol in (("x", x_tol), ("u", u_tol)):
        ref = np.asarray(getattr(jlog, k))
        diff = np.abs(getattr(log, k).numpy() - ref).max(-1)  # (B, T)
        floor = np.maximum.accumulate(np.max(
            [np.abs(np.asarray(getattr(f, k)) - ref).max(-1)
             for f in jfloors], axis=0), axis=1)
        bound = np.maximum(tol, 10.0 * floor)
        assert (diff <= bound).all(), (k, diff.max(), floor.max())
        out[k], out[k + "_floor"] = diff.max(), floor.max()
    np.testing.assert_allclose(log.r.numpy(), np.asarray(jlog.r), rtol=0,
                               atol=1e-12)
    return out


@pytest.mark.parametrize("name,reference", [
    ("vanderpol", "constant"),
    ("vanderpol_selftrained", "constant"),
    ("vanderpol", "sine"),
    ("vanderpol", "square"),
    ("vanderpol", "chirp"),
    ("vanderpol", "cos_sin_mix"),
])
def test_vdp_loop_matches_jax_run_batch(name, reference):
    """4 VDP scenarios x 16 steps through the switch at 8, float64, the
    preset's estimator (square-root RLS, inits 1e5): lifted-space tracking
    of the encoded [1, 0] (``vanderpol``), output tracking
    (``vanderpol_selftrained``) and the time-varying references (on the
    first lifted channel, as the JAX package puts them) against JAX
    ``run_batch``: x to 1e-9, u to 1e-8, the logged reference head
    (nlift wide when lifted) to 1e-12; |u| <= 6."""
    jcfg = _configure(JC.PRESETS[name](), reference)
    tcfg = _configure(TC.PRESETS[name](), reference)
    jcfg.lift.weights_path = resolve_weights_path(tcfg.lift.weights_path,
                                                  "vanderpol")
    jlogs, log, carry, pipe = run_both(jcfg, tcfg)
    assert_logs_match(jlogs, log)
    py = pipe.dictionary.nlift if tcfg.mpc.track_lifted else 2
    assert log.r.shape == (BATCH, STEPS, py)
    assert float(log.u.abs().max()) <= 6.0
    assert (pipe.params.ref_state is None) == (reference != "constant")


@pytest.mark.parametrize("step", [0, 150])
def test_lifted_control_solve_matches_jax(step):
    """One control solve under lifted tracking for 6 scenarios whose models
    are the ``vanderpol`` pipeline's initial model with per-scenario noise
    (C replaced by the identity before the QP), from states in [-2, 2]^2
    and a nonzero warm start, against JAX's ``make_control_solver`` on the
    same encoded reference window (the pipeline's own ref_fn): u and the
    warm start to 1e-9, the reference window to 1e-12, |u| <= 6. No
    closed-loop round-off grows here, so the stated tolerance holds."""
    jcfg = _configure(JC.vdp_lifted_preset())
    tcfg = _configure(TC.vdp_lifted_preset())
    jcfg.lift.weights_path = resolve_weights_path(tcfg.lift.weights_path,
                                                  "vanderpol")
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=F64)
    rng = np.random.default_rng(11 + step)
    b, nz = 6, pipe.dictionary.nlift
    a0, b0, c0 = (np.asarray(v) for v in jpipe.model0)
    model = (a0 + 0.01 * rng.normal(size=(b, nz, nz)),
             b0 + 0.05 * rng.normal(size=(b,) + b0.shape),
             c0 + 0.05 * rng.normal(size=(b,) + c0.shape))
    z = np.asarray(jpipe.dictionary(jnp.asarray(
        rng.uniform(-2.0, 2.0, size=(b, 2)))))
    warm = rng.uniform(-1.0, 1.0, size=(b, HORIZON))
    jsolve = jcore.make_control_solver(
        jpipe.dictionary, jpipe.engine_cfg,
        jref.encoded(jref.constant_state(jnp.asarray([1.0, 0.0]), HORIZON,
                                         jnp.float64), jpipe.dictionary, 2), 1)
    jdec = jax.vmap(lambda mdl, zz, wx: jsolve(
        jpipe.params, mdl, (), None, zz, jnp.zeros(1), wx, (),
        jnp.asarray(step)))(JModel(*(jnp.asarray(v) for v in model)),
                            jnp.asarray(z), jnp.asarray(warm))
    tsolve = tcore.make_control_solver(
        pipe.engine_cfg, ref_fn_for(tcfg, nz, "cpu", pipe.dictionary), 1)
    with torch.no_grad():
        tdec = tsolve(replicate(pipe.params, b),
                      TModel(*(torch.tensor(np.ascontiguousarray(v))
                               for v in model)),
                      torch.tensor(z), torch.zeros(b, 1, dtype=F64),
                      torch.tensor(warm), (), step)
    u = tdec.u_applied.numpy()
    np.testing.assert_allclose(u, np.asarray(jdec.u_applied), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tdec.warm_x.numpy(), np.asarray(jdec.warm_x),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(tdec.r_window.numpy(),
                               np.asarray(jdec.r_window)[0], rtol=0, atol=1e-12)
    assert tdec.r_window.shape == (HORIZON, nz)
    assert np.abs(u).max() <= 6.0 and np.abs(u).max() > 0.0
