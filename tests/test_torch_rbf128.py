"""The large-lift slice of koopmanx_torch against the JAX package: k-means
RBF centers, random Fourier features and their data-scaled bandwidth, the
pipeline carried across with the Woodbury lane's statistics and a Fourier
lift, and the closed loop of the ``duffing_rbf128`` and ``duffing_rff``
presets (at test size) against JAX ``run_batch`` on the same pipeline.
float64 unless stated; inputs from numpy with a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.lifts import fourier as jfourier  # noqa: E402
from koopmanx.lifts.rbf import kmeans as j_kmeans  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.lifts import fourier as tfourier  # noqa: E402
from koopmanx_torch.lifts.rbf import kmeans as t_kmeans, lloyd  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_dictionary, build_pipeline, replicate  # noqa: E402
from koopmanx_torch.systems.data import Snapshots  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402

F64 = torch.float64
BATCH, STEPS = 4, 16
CARRIED = ("g", "g_inv", "gz", "gz_inv", "mg", "mc")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [5, 12])
def test_kmeans_matches_jax_from_the_same_start(k):
    """Lloyd's 50 iterations from the k points that JAX's ``kmeans`` draws
    (``jax.random.choice`` without replacement, recomputed from its key):
    the same assignments exactly, the centers to 1e-12, in float64. The
    port's own ``kmeans`` draws k distinct points from its generator."""
    rng = np.random.default_rng(k)
    pts = np.concatenate([rng.normal(c, 0.3, size=(60, 2))
                          for c in ((-1, -1), (1, 1), (1, -1))])
    key = jax.random.PRNGKey(k)
    j_centers, j_assign = j_kmeans(key, jnp.asarray(pts), k)
    start = np.asarray(jax.random.choice(key, pts.shape[0], (k,),
                                         replace=False))
    t_centers, t_assign = lloyd(torch.tensor(pts), torch.tensor(pts[start]))
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(t_centers.numpy(), np.asarray(j_centers),
                               rtol=0, atol=1e-12)
    centers, assign = t_kmeans(torch.Generator().manual_seed(0),
                               torch.tensor(pts), k)
    assert centers.shape == (k, 2) and assign.shape == (pts.shape[0],)
    assert len(set(map(tuple, lloyd(torch.tensor(pts), centers, 0)[0]
                       .tolist()))) == k


def test_kmeans_keeps_an_empty_clusters_center():
    """A start center far from every point never wins a point: it keeps
    its place, as JAX's ``where(counts > 0, ...)`` does; the others move
    to their clusters' means."""
    pts = torch.tensor([[0.0, 0.0], [0.2, 0.0], [2.0, 2.0], [2.2, 2.0]],
                       dtype=F64)
    start = torch.tensor([[0.0, 0.1], [2.0, 2.1], [50.0, 50.0]], dtype=F64)
    centers, assign = lloyd(pts, start, iters=3)
    np.testing.assert_array_equal(centers.numpy(),
                                  [[0.1, 0.0], [2.1, 2.0], [50.0, 50.0]])
    assert assign.tolist() == [0, 0, 1, 1]


def test_rff_matches_jax():
    """The Fourier features of the same w (D, n) and b (D,) on a batch of
    states: the same matmul and cosine, 1e-12; the port's draws are
    N(0, 1) / bandwidth / feature_scale and U[0, 2 pi) from its
    generator."""
    rng = np.random.default_rng(3)
    w, b = rng.normal(size=(32, 2)), rng.uniform(0, 2 * np.pi, size=32)
    x = rng.uniform(-2, 2, size=(3, 7, 2))
    ref = np.asarray(jfourier.fourier_dictionary(jnp.asarray(w), jnp.asarray(b))(
        jnp.asarray(x)))
    d = tfourier.fourier_dictionary(torch.tensor(w), torch.tensor(b))
    assert d.nlift == 32 and d.n == 2
    np.testing.assert_allclose(d(torch.tensor(x)).numpy(), ref, rtol=0,
                               atol=1e-12)
    scale = torch.tensor([0.5, 2.0], dtype=F64)
    tw, tb = tfourier.rff_init(torch.Generator().manual_seed(1), 2, 32,
                               bandwidth=2.0, feature_scale=scale, dtype=F64)
    gen = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(
        tw.numpy(),
        (torch.randn((32, 2), generator=gen, dtype=F64) / 2.0 / scale).numpy())
    assert tb.min() >= 0.0 and tb.max() < 2 * np.pi


def test_fourier_bandwidth_is_in_units_of_the_population_std():
    """``build_dictionary`` for a Fourier lift scales the frequencies by
    the training states' std with ddof 0 (``jnp.std``; torch's default
    is ddof 1), floored at 1e-3 (the flat second channel here)."""
    rng = np.random.default_rng(5)
    x = np.stack([rng.normal(0.0, 1.7, size=40), np.full(40, 0.25)], axis=1)
    data = Snapshots(x=torch.tensor(x), y=torch.tensor(x),
                     u=torch.zeros((40, 1), dtype=F64))
    cfg = TC.duffing_rff_preset()
    cfg.dtype = "float64"
    cfg.lift.state_augmented = cfg.lift.normalize = False
    d = build_dictionary(cfg, data, torch.Generator().manual_seed(2))
    scale = np.maximum(np.asarray(jnp.std(jnp.asarray(x), axis=0)), 1e-3)
    assert scale[1] == 1e-3
    draws = torch.randn((32, 2), generator=torch.Generator().manual_seed(2),
                        dtype=F64).numpy()
    np.testing.assert_allclose(d.encoder.w.numpy(),
                               draws / cfg.lift.rff_bandwidth / scale,
                               rtol=1e-15, atol=0)


def _configure(cfg, dtype="float64", steps=STEPS, nlift=None, window=32):
    """A Woodbury preset at test size: ``steps`` steps with the switch
    half-way, 20x20 data, a window of 32 (16 steps evict half of its
    prefilled rows), the kernel route (its plain version on CPU
    tensors)."""
    cfg.steps = steps
    cfg.dtype = dtype
    cfg.switch_step = steps // 2
    cfg.mpc.qp_backend = "pallas"
    cfg.data = dataclasses.replace(cfg.data, n_step=20, n_traj=20)
    cfg.update.window = window
    if nlift is not None:
        cfg.lift.nlift = nlift
    return cfg


def _rbf128_pair(dtype="float64", steps=STEPS, anchor=0, nlift=14,
                 window=32):
    """``rbf128_bench_config`` (the port) and ``duffing_rbf128_preset``
    with the bench's horizon 20 (JAX), at test size: nlift 14 + 2 (the
    state) unless given, an exact rebuild every ``anchor`` steps (0:
    never)."""
    pair = (TC.rbf128_bench_config(steps=steps), JC.duffing_rbf128_preset())
    for cfg in pair:
        cfg.mpc.horizon = 20
        cfg.update.window_anchor = anchor
        _configure(cfg, dtype, steps, nlift, window)
    return pair


def _arrays_from_jax(pipe):
    """The JAX pipeline as ``convert.pipeline_from_numpy`` reads it: a
    normalized, state-augmented RBF or Fourier lift, the Woodbury rings
    and carried statistics (a compressed ring arrives as float32)."""
    n = lambda tree: jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)
    inner, mu, sc = n(pipe.dictionary.params)
    lc = pipe.config.lift
    base = ({"fourier": {"w": inner[0], "b": inner[1]}} if lc.kind == "fourier"
            else {"rbf": {"centers": inner, "kind": lc.rbf_type}})
    p = pipe.params
    keys = ("q_block", "r_block", "u_min", "u_max", "cy", "applied_min",
            "applied_max", "ref_state")
    return {
        **base,
        "state_augmented": lc.state_augmented,
        "normalizer": (mu, sc),
        "model0": tuple(n(pipe.model0)),
        "rls0": {k: n(v) for k, v in pipe.rls0._asdict().items()
                 if not isinstance(v, tuple)},
        "params": {k: None if getattr(p, k) is None else n(getattr(p, k))
                   for k in keys},
        "x_init": n(pipe.x_init),
    }


def _scenarios(batch, seed=0):
    """x0 ~ U[-2, 2]^2 and per-scenario Duffing parameters within 15 % of
    the nominal and switched values."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2.0, 2.0, size=(batch, 2))
    th0 = np.array([-0.5, 1.0, -1.0]) * (1 + rng.uniform(-.15, .15, (batch, 3)))
    th1 = np.array([-5.0, 2.0, -0.5]) * (1 + rng.uniform(-.15, .15, (batch, 3)))
    return x0, th0, th1


def _run_both(jcfg, tcfg, batch=BATCH, dtype=F64):
    """The JAX pipeline built from ``jcfg``, carried across into the port
    under ``tcfg``, both run over the same scenarios; returns the two
    logs, the port's carry and pipeline."""
    jpipe = j_build_pipeline(jcfg)
    pipe = pipeline_from_numpy(_arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=dtype)
    x0, th0, th1 = _scenarios(batch)
    jd = jnp.float64 if dtype == F64 else jnp.float32
    rep = lambda v: jnp.broadcast_to(v, (batch,) + v.shape)
    _, jlog = j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params),
        jnp.asarray(x0, jd), jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        JDuffing(*jnp.asarray(th0.T, jd)), JDuffing(*jnp.asarray(th1.T, jd)))
    launches = box_admm.launches
    carry, log = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, batch),
        torch.tensor(x0, dtype=dtype), replicate(pipe.model0, batch),
        replicate(pipe.rls0, batch), TDuffing(*torch.tensor(th0.T, dtype=dtype)),
        TDuffing(*torch.tensor(th1.T, dtype=dtype)))
    assert box_admm.launches == launches  # CPU tensors: the plain version
    return jlog, log, carry, pipe


@pytest.mark.parametrize("case", ["rbf128", "rbf128-anchor4", "rff"])
def test_woodbury_loop_matches_jax_run_batch(case):
    """4 scenarios x 16 steps in float64 through the switch at step 8:
    ``duffing_rbf128`` as the bench runs it (horizon 20, nx = 20) at nlift
    16 and window 32, the same with an exact rebuild every 4th step, and
    ``duffing_rff`` (its 32 features, horizon 10, nx = 10) at window 32.
    x to 1e-9 (the same f64 arithmetic up to summation order); u to 1e-8:
    at the first unsaturated steps the QP amplifies round-off in the
    model, and the port run against itself with x0 moved by one ulp gives
    u up to 8.6e-9 apart at ``duffing_rff`` (the loop's own floor; x stays
    within 4e-10 of it). The carried statistics stay finite, |u| <= 2."""
    if case == "rff":
        tcfg = _configure(TC.duffing_rff_preset())
        jcfg = _configure(JC.duffing_rff_preset())
    else:
        tcfg, jcfg = _rbf128_pair(anchor=4 if case.endswith("anchor4") else 0)
    jlog, log, carry, pipe = _run_both(jcfg, tcfg)
    assert pipe.rls0.g is not None
    assert pipe.dictionary.nlift == (34 if case == "rff" else 16)
    jx, tx = np.asarray(jlog.x), log.x.numpy()
    assert tx.shape == (BATCH, STEPS, 2)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(log.u.numpy(), np.asarray(jlog.u), rtol=0,
                               atol=1e-8)
    assert all(bool(torch.isfinite(getattr(carry.rls, k)).all())
               for k in CARRIED)
    assert float(log.u.abs().max()) <= 2.0


def test_woodbury_loop_f32_tail_quality_matches_jax():
    """float32, the rbf128 shape at nlift 16, 4 scenarios x 60 steps (the
    switch at 30): the batch-mean |x1 - 1| over the last 20 steps within
    1e-3 relative of JAX's on the same pipeline (float32 round-off grows
    through the loop, so the runs are held by their tracking quality)."""
    tcfg, jcfg = _rbf128_pair(dtype="float32", steps=60)
    jlog, log, _, _ = _run_both(jcfg, tcfg, dtype=torch.float32)
    jt = np.abs(np.asarray(jlog.x)[:, -20:, 0] - 1.0).mean()
    tt = np.abs(log.x.numpy()[:, -20:, 0] - 1.0).mean()
    assert np.isfinite(log.x.numpy()).all()
    assert abs(tt - jt) <= 1e-3 * abs(jt), (tt, jt)


def test_rbf128_preset_loop_at_nlift_128_matches_jax():
    """The preset's own lift, 126 k-means centers + the state (nlift 128,
    the carried Gram 129 x 129), window 256, 2 scenarios x 8 steps in
    float64 on 20x20 data: x to 1e-9 against JAX."""
    tcfg, jcfg = _rbf128_pair(steps=8, nlift=126, window=256)
    jlog, log, carry, pipe = _run_both(jcfg, tcfg, batch=2)
    assert pipe.dictionary.nlift == 128 and carry.rls.g.shape == (2, 129, 129)
    np.testing.assert_allclose(log.x.numpy(), np.asarray(jlog.x), rtol=0,
                               atol=1e-9)


def test_pipeline_with_woodbury_statistics_round_trips():
    """A Fourier-lift pipeline with the Woodbury statistics and a bf16
    ring: the ring arrives as float32 and is cast back to bf16 (exact), the
    carried fields keep the run's dtype, and ``pipeline_to_numpy`` gives
    every array back; a pipeline without the carried fields reads them as
    None and passes the Nones through."""
    jcfg = _configure(JC.duffing_rff_preset())
    jcfg.update.window_store = "bfloat16"
    jpipe = j_build_pipeline(jcfg)
    arrays = _arrays_from_jax(jpipe)
    tcfg = _configure(TC.duffing_rff_preset())
    tcfg.update.window_store = "bfloat16"
    pipe = pipeline_from_numpy(arrays, tcfg, device="cpu", dtype=F64)
    assert pipe.rls0.zx.dtype == torch.bfloat16
    assert pipe.rls0.g.dtype == F64 and pipe.rls0.idx.dtype == torch.int32
    back = pipeline_to_numpy(pipe)
    for k in ("w", "b"):
        np.testing.assert_array_equal(back["fourier"][k], arrays["fourier"][k])
    for k, v in arrays["rls0"].items():
        np.testing.assert_array_equal(back["rls0"][k], v)
    x = np.random.default_rng(1).uniform(-2, 2, size=(8, 2))
    with torch.no_grad():
        z = pipe.dictionary(torch.tensor(x)).numpy()
    np.testing.assert_allclose(z, np.asarray(jpipe.dictionary(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    chain = dict(arrays, rls0={k: arrays["rls0"][k]
                               for k in ("zx", "u", "zy", "x", "idx")})
    tcfg.update.window_carry, tcfg.update.window_store = "none", "float32"
    plain = pipeline_from_numpy(chain, tcfg, device="cpu", dtype=F64)
    assert all(getattr(plain.rls0, k) is None for k in CARRIED)
    assert plain.rls0.zx.dtype == F64
    assert all(pipeline_to_numpy(plain)["rls0"][k] is None for k in CARRIED)


@pytest.mark.parametrize("store", ["float32", "bfloat16", "float16"])
def test_build_pipeline_builds_the_rbf128_preset_on_cpu(store):
    """The port's own setup for ``duffing_rbf128``: 100x100 data, 126
    k-means centers + the state (nlift 128), the window of 256 in its
    storage dtype, the carried statistics built from it in float32
    (``g`` is the ring's ridge Gram, ``g_inv`` its inverse); a few steps
    run finite."""
    cfg = TC.duffing_rbf128_preset()
    cfg.update.window_store = store
    cfg.steps = 3
    pipe = build_pipeline(cfg, device="cpu")
    st = pipe.rls0
    assert pipe.dictionary.nlift == 128 and st.zx.shape == (256, 128)
    assert st.zx.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                           "float16": torch.float16}[store]
    assert st.g.shape == (129, 129) and st.g.dtype == torch.float32
    v = torch.cat([st.zx, st.u], -1).double()
    np.testing.assert_allclose(st.g.double().numpy(),
                               (v.T @ v + torch.eye(129, dtype=F64)).numpy(),
                               rtol=1e-5, atol=1e-3)
    eye = (st.g.double() @ st.g_inv.double()).numpy()
    np.testing.assert_allclose(eye, np.eye(129), rtol=0, atol=1e-3)
    x0 = torch.tensor(_scenarios(2)[0], dtype=torch.float32)
    _, log = t_run_batch(pipe.closed_loop, replicate(pipe.params, 2), x0,
                         replicate(pipe.model0, 2), replicate(pipe.rls0, 2))
    assert torch.isfinite(log.x).all() and log.u.abs().max() <= 2.0
