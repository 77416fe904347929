"""The Revise_2 building blocks of koopmanx_torch against the JAX package:
the MATLAB RK4 and the toy1d plant, the pivoted Gauss-Jordan inverse, the
DARE / LQR utilities, the terminal certificate and its monitors, the
batched terminal-block override of Qbar, the NaN-faithful Cholesky and the
three warm starts from the batch Grams. float64 on the CPU, inputs from
numpy with a seed; where the JAX function is per scenario it runs under
``jax.vmap``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.control import condensed as jcond  # noqa: E402
from koopmanx.control import dare as jdare  # noqa: E402
from koopmanx.control import terminal as jterm  # noqa: E402
from koopmanx.edmd import batch as jbatch  # noqa: E402
from koopmanx.edmd import rls as jrls  # noqa: E402
from koopmanx.ops import linalg as jlinalg  # noqa: E402
from koopmanx.systems import base as jsys  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch.control import condensed as tcond  # noqa: E402
from koopmanx_torch.control import dare as tdare  # noqa: E402
from koopmanx_torch.control import terminal as tterm  # noqa: E402
from koopmanx_torch.edmd import batch as tbatch  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.ops import linalg as tlinalg  # noqa: E402
from koopmanx_torch.systems import base as tsys  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

B = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def vjax(fn, *arrays):
    """``jax.jit(jax.vmap(fn))`` over numpy arrays, as numpy."""
    out = jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in arrays))
    return jax.tree_util.tree_map(np.asarray, out)


def tt(*arrays):
    return [torch.tensor(np.ascontiguousarray(a)) for a in arrays]


def assert_close_rel(got, ref, rtol):
    """Within ``rtol`` of the reference's largest |entry|, with the same
    NaN pattern."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = max(np.nanmax(np.abs(ref)), 1e-300) if np.isfinite(ref).any() \
        else 1.0
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                               rtol=0, atol=rtol * scale)


# ---- the MATLAB RK4 and the toy1d plant ----

PLANTS = {"duffing": (jlib.DUFFING, tlib.DUFFING),
          "toy1d": (jlib.TOY1D, tlib.TOY1D)}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_rk4_step_k1k4_matches_jax(name):
    """``integrator='rk4_matlab'`` (k4 at x + h k1) at per-scenario
    parameters within 15 % of the nominal values, states and inputs in
    [-2, 2]: the same elementwise operations, 1e-12; it differs from the
    classic RK4 of the same plant."""
    jsystem, tsystem = PLANTS[name]
    rng = np.random.default_rng(3)
    x = rng.uniform(-2.0, 2.0, size=(32, jsystem.n))
    u = rng.uniform(-2.0, 2.0, size=(32, 1))
    th = np.array(jsystem.theta0) * (1 + rng.uniform(-.15, .15, (32, 3)))
    params = type(jsystem.theta0)
    jstep = jsys.make_step(jsystem, 0.05, "rk4_matlab")
    ref = vjax(lambda xx, uu, t: jstep(xx, uu, params(*t)), x, u, th)
    tx, tu, tth = tt(x, u, th)
    tstep = tsys.make_step(tsystem, 0.05, "rk4_matlab")
    out = tstep(tx, tu, type(tsystem.theta0)(*tth.T)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    classic = tsys.make_step(tsystem, 0.05)(tx, tu,
                                            type(tsystem.theta0)(*tth.T))
    assert np.abs(classic.numpy() - out).max() > 1e-6


def test_toy1d_plant_and_scenarios():
    """The one-state toy plant: its field against JAX (1e-12), theta1 =
    theta0 (no switch), in the registry; ``sample_scenarios`` draws (B, 1)
    states and perturbs all three parameters."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-2.0, 2.0, size=(16, 1))
    u = rng.uniform(-1.0, 1.0, size=(16, 1))
    ref = vjax(lambda xx, uu: jlib.TOY1D.f(0.0, xx, uu, jlib.TOY1D.theta0),
               x, u)
    th = tlib.Toy1dParams(*(torch.tensor(v, dtype=torch.float64)
                            for v in tlib.TOY1D.theta0))
    out = tlib.TOY1D.f(0.0, *tt(x, u), th).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    assert tlib.get_system("toy1d") is tlib.TOY1D
    assert tlib.TOY1D.theta0 == tlib.TOY1D.theta1 == tlib.Toy1dParams(
        *jlib.TOY1D.theta0)
    sc = sample_scenarios(tlib.TOY1D, torch.Generator().manual_seed(1), 64,
                          param_scale=0.15, dtype=torch.float64,
                          device="cpu")
    assert sc.x0.shape == (64, 1)
    for leaf, nominal in zip(sc.theta0, tlib.TOY1D.theta0):
        ratio = leaf.numpy() / nominal
        assert leaf.shape == (64,) and np.abs(ratio - 1).max() <= 0.15
        assert ratio.std() > 0.02


# ---- Gauss-Jordan with partial pivoting ----

def gj_inputs(n, seed):
    """B random matrices, one with a zero leading pivot (a row swap at
    j = 0), one with a NaN entry, one exactly singular."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, n, n)) + 0.5 * np.eye(n)
    a[0, 0, 0] = 0.0
    a[1, n // 2, 1] = np.nan
    a[2, :, -1] = a[2, :, 0]
    return a


@pytest.mark.parametrize("n", [3, 10, 20])
def test_gj_inverse_matches_jax(n):
    """Batched ``gj_inverse`` against JAX's on the same matrices: 1e-12
    relative, the NaN pattern equal (the NaN and the singular matrix give
    non-finite inverses in both), and a true inverse of the others."""
    a = gj_inputs(n, n)
    ref = np.asarray(jlinalg.gj_inverse(jnp.asarray(a)))
    out = tlinalg.gj_inverse(torch.tensor(a)).numpy()
    np.testing.assert_array_equal(np.isfinite(out), np.isfinite(ref))
    for k in range(B):
        if np.isfinite(ref[k]).all():
            assert_close_rel(out[k], ref[k], 1e-12)
            assert np.abs(out[k] @ a[k] - np.eye(n)).max() < 1e-9
    assert not np.isfinite(out[1]).all()


def test_gj_tables_built_under_inference_mode_serve_autograd():
    """``gj_inverse``'s cached tables, first built inside
    ``torch.inference_mode`` (as the engine's loop runs), still serve a
    later call that records a gradient."""
    tlinalg._gj_tables.cache_clear()
    a = torch.tensor(gj_inputs(10, 10)[:1])
    with torch.inference_mode():
        tlinalg.gj_inverse(a)
    a.requires_grad_(True)
    tlinalg.gj_inverse(a).sum().backward()
    assert torch.isfinite(a.grad).all()


def test_gj_solve_matches_jax():
    """``gj_solve(a, b)`` = ``gj_inverse(a) @ b`` against JAX's, 1e-12
    relative, NaN pattern equal; a leading batch axis of its own on
    ``b`` broadcasts."""
    a = gj_inputs(10, 7)
    rng = np.random.default_rng(8)
    b = rng.normal(size=(B, 10, 4))
    ref = np.asarray(jlinalg.gj_solve(jnp.asarray(a), jnp.asarray(b)))
    out = tlinalg.gj_solve(*tt(a, b)).numpy()
    assert_close_rel(np.where(np.isfinite(out), out, np.nan),
                     np.where(np.isfinite(ref), ref, np.nan), 1e-12)


# ---- DARE / LQR ----

def plants(n, seed, m=1):
    """B random stabilizable pairs (A, B): A with spectral radius 0.6-1.2
    (some open-loop unstable), B Gaussian; Q = diag(10, 10, 0, ...) (the
    Revise_2 lifted weight) in half the batch, 10 I in the other; R =
    0.01 I. One pair is made uncontrollable in its last state, which A
    keeps stable."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, n, n))
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    a *= rng.uniform(0.6, 1.2, size=(B, 1, 1)) / radius[:, None, None]
    b = rng.normal(size=(B, n, m))
    a[-1, -1, :-1] = 0.0
    a[-1, -1, -1] = 0.5
    b[-1, -1] = 0.0
    q = np.zeros((B, n, n))
    q[: B // 2] = np.diag([10.0, 10.0] + [0.0] * (n - 2))
    q[B // 2:] = 10.0 * np.eye(n)
    r = np.broadcast_to(0.01 * np.eye(m), (B, m, m)).copy()
    return a, b, q, r


def _stable(a):
    """A scaled to spectral radius 0.9 (for the Lyapunov doubling)."""
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    return 0.9 * a / radius[:, None, None]


DARE_CASES = {
    "solve_dare_doubling": (jdare.solve_dare_doubling,
                            tdare.solve_dare_doubling, "abqr"),
    "solve_dare_iter": (jdare.solve_dare_iter, tdare.solve_dare_iter,
                        "abqr"),
    "dlqr": (jdare.dlqr, tdare.dlqr, "abqr"),
    "dlqr_iter": (lambda a, b, q, r: jdare.dlqr(a, b, q, r, method="iter"),
                  lambda a, b, q, r: tdare.dlqr(a, b, q, r, method="iter"),
                  "abqr"),
    "dlqr_gain": (jdare.dlqr_gain, tdare.dlqr_gain, "abqrp"),
    "solve_dlyap_doubling": (jdare.solve_dlyap_doubling,
                             tdare.solve_dlyap_doubling, "sq"),
}


def assert_within_floor(got, ref, nudged, rtol):
    """Each scenario within ``rtol`` of its largest |entry|, or within ten
    times the JAX function's own change there when its A moves by one ulp
    (up, then down), where that is larger: a nearly unstable pair's DARE
    amplifies round-off past 1e-9 in JAX itself."""
    axes = tuple(range(1, ref.ndim))
    diff = np.abs(got - ref).max(axis=axes)
    floor = np.max([np.abs(v - ref).max(axis=axes) for v in nudged], axis=0)
    bound = np.maximum(rtol * np.abs(ref).max(axis=axes), 10.0 * floor)
    assert (diff <= bound).all(), (diff, bound)
    return diff, floor


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("name", sorted(DARE_CASES))
def test_dare_utilities_match_jax(name, n):
    """Each DARE / LQR utility on a batch of random stabilizable (A, B) at
    n = 8 and 10, m = 1, against ``jax.vmap`` of the JAX function: every
    output of each scenario within 1e-9 of its largest |entry| (P's norm
    for P, K's for K), or within ten times JAX's own one-ulp-of-A floor
    there (``assert_within_floor``). The doubling's P solves the DARE to
    1e-8 relative."""
    jfn, tfn, args = DARE_CASES[name]
    a, b, q, r = plants(n, 10 + n)
    p = vjax(jdare.solve_dare_doubling, a, b, q, r) if "p" in args else None

    def inputs(a_):
        pick = {"a": a_, "b": b, "q": q, "r": r, "p": p, "s": _stable(a_)}
        return [pick[k] for k in args]

    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    ref = as_tuple(vjax(jfn, *inputs(a)))
    nudged = [as_tuple(vjax(jfn, *inputs(np.nextafter(a, t))))
              for t in (9.0, -9.0)]
    out = as_tuple(tfn(*tt(*inputs(a))))
    for i, (o, rr) in enumerate(zip(out, ref)):
        assert o.shape == rr.shape and np.isfinite(rr).all()
        assert_within_floor(o.numpy(), rr, [v[i] for v in nudged], 1e-9)
    if name == "solve_dare_doubling":
        pt = out[0].numpy()
        at, bt = a.transpose(0, 2, 1), b.transpose(0, 2, 1)
        gain = np.linalg.solve(r + bt @ pt @ b, bt @ pt @ a)
        res = at @ pt @ a - at @ pt @ b @ gain + q - pt
        assert np.abs(res).max() <= 1e-8 * np.abs(pt).max()


@pytest.mark.parametrize("n", [8, 10])
def test_controllability_rank_matches_jax(n):
    """rank [B AB ... A^{n-1} B]: n for the random pairs, n - 1 for the
    pair made uncontrollable in its last state, as JAX counts it."""
    a, b, _, _ = plants(n, 20 + n)
    ref = vjax(jdare.controllability_rank, a, b)
    out = tdare.controllability_rank(*tt(a, b)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert list(out) == [n] * (B - 1) + [n - 1]


# ---- terminal certificate and monitors ----

def terminal_inputs(seed, nz=10, n=2, m=1):
    """A batch of models and states in the shapes of revise2_duffing
    (nlift 10, two states, one input), the DARE certificate of each, and
    one model whose C P C' / gamma is indefinite (a negated P)."""
    rng = np.random.default_rng(seed)
    a, b, q, r = plants(nz, seed, m)
    c = rng.normal(size=(B, n, nz))
    z, z_next = rng.normal(size=(2, B, nz))
    u = rng.uniform(-2, 2, size=(B, m))
    x_next = rng.normal(size=(B, n))
    cert = vjax(lambda aa, bb, cc, qq, rr: jterm.synthesize_terminal(
        JModel(aa, bb, cc), qq, rr), a, b, c, q, r)
    p, k, gamma = (np.array(v) for v in cert)
    p[0] = -p[0]
    return dict(a=a, b=b, c=c, q=q, r=r, z=z, z_next=z_next, u=u,
                x_next=x_next, p=p, k=k, gamma=gamma,
                psi=rng.normal(size=(B, nz)), x_err=rng.normal(size=(B, n)))


TERMINAL_CASES = {
    "synthesize_terminal": (
        lambda a, b, c, q, r: jterm.synthesize_terminal(JModel(a, b, c), q,
                                                        r),
        lambda a, b, c, q, r: tterm.synthesize_terminal(TModel(a, b, c), q,
                                                        r),
        "abcqr"),
    "prediction_residual": (
        lambda a, b, c, z, u, x: jterm.prediction_residual(JModel(a, b, c),
                                                           z, u, x),
        lambda a, b, c, z, u, x: tterm.prediction_residual(TModel(a, b, c),
                                                           z, u, x),
        ("a", "b", "c", "z", "u", "x_next")),
    "lifted_residual": (
        lambda a, b, c, z, u, zn: jterm.lifted_residual(JModel(a, b, c), z,
                                                        u, zn),
        lambda a, b, c, z, u, zn: tterm.lifted_residual(TModel(a, b, c), z,
                                                        u, zn),
        ("a", "b", "c", "z", "u", "z_next")),
    "lyapunov_value": (jterm.lyapunov_value, tterm.lyapunov_value,
                       ("p", "psi")),
    "ellipsoid_radius": (jterm.ellipsoid_radius, tterm.ellipsoid_radius,
                         ("p", "c", "gamma")),
    "compensator_term": (
        lambda a, b, c, k, z, u, zn: jterm.compensator_term(
            JModel(a, b, c), k, z, u, zn),
        lambda a, b, c, k, z, u, zn: tterm.compensator_term(
            TModel(a, b, c), k, z, u, zn),
        ("a", "b", "c", "k", "z", "u", "z_next")),
    "gamma_margin": (jterm.gamma_margin, tterm.gamma_margin,
                     ("p", "c", "gamma", "psi", "x_err")),
}


@pytest.mark.parametrize("name", sorted(TERMINAL_CASES))
def test_terminal_function_matches_jax(name):
    """Each function of ``control/terminal.py`` on a batch in
    revise2_duffing's shapes against ``jax.vmap`` of JAX's: 1e-9 of the
    largest |entry| (the DARE inside the synthesis), 1e-12 for the
    closed-form monitors; the ellipsoid radius of the indefinite
    scenario is NaN below the diagonal and 0 above, as JAX's Cholesky
    gives it."""
    jfn, tfn, args = TERMINAL_CASES[name]
    data = terminal_inputs(30)
    inputs = [data[k] for k in args]
    ref = vjax(jfn, *inputs)
    out = tfn(*tt(*inputs))
    rtol = 1e-9 if name == "synthesize_terminal" else 1e-12
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for o, rr in zip(outs, refs):
        assert_close_rel(o.numpy(), rr, rtol)
    if name == "ellipsoid_radius":
        bad = outs[0].numpy()[0]
        assert np.isnan(bad[np.tril_indices(bad.shape[-1])]).all()
        assert (np.triu(bad, 1) == 0).all()
        assert np.isfinite(outs[0].numpy()[1:]).all()
    if name == "synthesize_terminal":
        p, _, gamma = (o.numpy() for o in outs)
        np.testing.assert_allclose(gamma, np.trace(p, axis1=1, axis2=2),
                                   rtol=1e-14)


def test_cholesky_failure_pattern_matches_jax():
    """``ops/linalg.cholesky`` on a batch with a positive-definite, an
    indefinite, a non-symmetric positive-definite (symmetrized first, as
    JAX does) and a NaN matrix: JAX's factors to 1e-12 and its NaN
    pattern (the whole lower triangle, 0 above) where the factorization
    fails. The NaN matrix gets the whole lower triangle NaN, a superset of
    JAX's (its CPU LAPACK leaves NaN only where they propagate)."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(4, 6, 6))
    mats = g @ g.transpose(0, 2, 1) + 0.1 * np.eye(6)
    mats[1, 2, 2] = -5.0
    mats[2] += 0.3 * np.triu(rng.normal(size=(6, 6)), 1)
    mats[3, 0, 4] = np.nan
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(mats)))
    out = tlinalg.cholesky(torch.tensor(mats)).numpy()
    lower = np.tril_indices(6)
    np.testing.assert_array_equal(np.isnan(out[:3]), np.isnan(ref[:3]))
    np.testing.assert_allclose(np.nan_to_num(out[:3]), np.nan_to_num(ref[:3]),
                               rtol=0, atol=1e-12 * np.abs(ref[0]).max())
    assert np.isnan(ref[1][lower]).all()
    assert np.isnan(ref[3]).any()
    assert (np.isnan(ref[3]) <= np.isnan(out[3])).all()
    for k in (1, 3):
        assert np.isnan(out[k][lower]).all()
        assert (np.triu(out[k], 1) == 0).all()


# ---- the batched terminal block of Qbar ----

@pytest.mark.parametrize("batched_q", [False, True], ids=["shared_q",
                                                          "batched_q"])
def test_weight_bar_with_batched_terminal_matches_jax(batched_q):
    """Qbar = kron(I_N, Q) with each scenario's own last block (the
    injected C P C'): (B, N*py, N*py) from a shared or a batched Q,
    equal to ``jax.vmap`` of JAX's ``weight_bar``; the rest of Qbar is
    Q's. ``condensed_qp`` takes it and gives JAX's P and q (1e-12)."""
    rng = np.random.default_rng(6)
    horizon, py, nz, m = 5, 2, 4, 1
    q_block = np.diag([10.0, 3.0])
    term = rng.normal(size=(B, py, py))
    term = term @ term.transpose(0, 2, 1)
    ref = vjax(lambda t: jcond.weight_bar(jnp.asarray(q_block), horizon, t),
               term)
    tq = torch.tensor(q_block)
    if batched_q:
        tq = tq.expand(B, py, py)
    out = tcond.weight_bar(tq, horizon, torch.tensor(term))
    assert out.shape == (B, horizon * py, horizon * py)
    np.testing.assert_array_equal(out.numpy(), ref)
    plain = np.broadcast_to(tcond.weight_bar(tq, horizon).numpy(), out.shape)
    np.testing.assert_array_equal(plain[:, :-py], out.numpy()[:, :-py])
    np.testing.assert_array_equal(plain[:, :, :-py], out.numpy()[:, :, :-py])
    f1 = rng.normal(size=(B, horizon * py, nz))
    f2 = rng.normal(size=(B, horizon * py, horizon * m))
    z0, yr = rng.normal(size=(B, nz)), rng.normal(size=(B, horizon * py))
    rbar = 0.01 * np.eye(horizon * m)
    lo, hi = -np.ones(horizon * m), np.ones(horizon * m)
    jqp = vjax(lambda a1, a2, z, y, qb: jcond.condensed_qp(
        jcond.PredictionMatrices(a1, a2), z, y, qb, jnp.asarray(rbar),
        jnp.asarray(lo), jnp.asarray(hi)), f1, f2, z0, yr, ref)
    tqp = tcond.condensed_qp(tcond.PredictionMatrices(*tt(f1, f2)),
                             *tt(z0, yr), out, *tt(rbar, lo, hi))
    for got, want in ((tqp.P, jqp.P), (tqp.q, jqp.q)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


# ---- warm starts from the batch Grams ----

def gram_stats(indefinite, seed=12):
    """GramStats of seeded lifted snapshots (S = 40, nlift 6, m = 1,
    n = 2); ``indefinite`` makes both Grams indefinite (a negated diagonal
    entry), as no snapshot set could."""
    rng = np.random.default_rng(seed)
    zx, zy = rng.normal(size=(2, 40, 6))
    u, x = rng.normal(size=(40, 1)), rng.normal(size=(40, 2))
    stats = jax.tree_util.tree_map(np.asarray, jbatch.gram_stats(
        *(jnp.asarray(v) for v in (zx, zy, u, x))))
    if indefinite:
        gvv, gzz = stats.gvv.copy(), stats.gzz.copy()
        gvv[3, 3], gzz[2, 2] = -gvv[3, 3], -gzz[2, 2]
        stats = stats._replace(gvv=gvv, gzz=gzz)
    return stats


INITS = {"rls_init_from_grams": (jrls.rls_init_from_grams,
                                 trls.rls_init_from_grams),
         "sqrt_rls_init_from_grams": (jrls.sqrt_rls_init_from_grams,
                                      trls.sqrt_rls_init_from_grams),
         "gram_rls_init_from_grams": (jrls.gram_rls_init_from_grams,
                                      trls.gram_rls_init_from_grams)}


@pytest.mark.parametrize("indefinite", [False, True],
                         ids=["gram_psd", "gram_indefinite"])
@pytest.mark.parametrize("name", sorted(INITS))
def test_init_from_grams_matches_jax(name, indefinite):
    """Each warm start from the same GramStats: every field of JAX's state
    to 1e-10 of its largest |entry| (the pinv's SVD, the Cholesky), the
    NaN pattern equal: an indefinite Gram gives NaN below the diagonal of
    the square-root factor's transpose (its lower triangle), a finite
    pinv, the raw Gram."""
    jfn, tfn = INITS[name]
    stats = gram_stats(indefinite)
    ref = jfn(jax.tree_util.tree_map(jnp.asarray, stats))
    out = tfn(tbatch.GramStats(*tt(*stats)))
    assert type(out).__name__ == type(ref).__name__
    assert out._fields == ref._fields
    for field in ref._fields:
        got, want = getattr(out, field), np.asarray(getattr(ref, field))
        if field == "count":
            assert got.dtype == torch.int32 and got.shape == want.shape == ()
            continue
        assert_close_rel(got.numpy(), want, 1e-10)
    if name == "sqrt_rls_init_from_grams":
        assert np.isnan(out.r_g.numpy()).any() == indefinite
