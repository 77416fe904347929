"""The control laws of koopmanx_torch that use no Koopman estimator,
against the JAX package: the plant Jacobians (``systems/linearize.py``),
the affine lift psi(x) = [x; 1] and the local-linearization MPC baseline
(``engine/local_linear.py``), and the single-shooting cost with its
projected-gradient solver (``control/shooting.py``). float64 on the CPU,
inputs from numpy with a seed; where the JAX function is per point it
runs under ``jax.vmap``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control import shooting as jshoot  # noqa: E402
from koopmanx.engine import local_linear as jll  # noqa: E402
from koopmanx.lifts.base import constant_augmented as j_constant_augmented  # noqa: E402
from koopmanx.run import _mpc_params as j_mpc_params  # noqa: E402
from koopmanx.run import _ref_fn as j_ref_fn  # noqa: E402
from koopmanx.run import engine_config as j_engine_config  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.systems import linearize as jlin  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control import shooting as tshoot  # noqa: E402
from koopmanx_torch.engine import local_linear as tll  # noqa: E402
from koopmanx_torch.lifts.base import constant_augmented  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_local_linear, replicate  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.systems import linearize as tlin  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

B = 8
# (JAX system, port system, parameter class in each, nominal values,
# state range)
PLANTS = {
    "duffing": (jlib.DUFFING, tlib.DUFFING, jlib.DuffingParams,
                tlib.DuffingParams, (-2.0, 2.0)),
    "vanderpol": (jlib.VANDERPOL, tlib.VANDERPOL, jlib.VdpParams,
                  tlib.VdpParams, (-2.0, 2.0)),
    "tank": (jlib.TANK, tlib.TANK, jlib.TankParams, tlib.TankParams,
             (0.1, 3.0)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def points(name, seed=0):
    """B operating points (x, u) in the plant's range and per-point
    parameters within 15 % of the nominal ones."""
    jsys, _, _, _, (lo, hi) = PLANTS[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(B, jsys.n))
    u = rng.uniform(-2.0, 2.0, size=(B, jsys.m))
    th = np.array(jsys.theta0) * (1 + rng.uniform(-.15, .15,
                                                  (B, len(jsys.theta0))))
    return x, u, th


def both_linearize(name, x, u, th, integrator):
    """(JAX's A, B, d; the port's A, B, d) at the points."""
    jsys, tsys, jp, tp, _ = PLANTS[name]

    def jfn(xx, uu, t):
        loc = jlin.linearize_discrete(jsys, xx, uu, 0.05, jp(*t), integrator)
        d = jlin.affine_residual(jsys, xx, uu, loc, 0.05, jp(*t), integrator)
        return loc.A, loc.B, loc.C, d

    ja, jb, jc, jd = (np.asarray(v) for v in jax.jit(jax.vmap(jfn))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(th)))
    tx, tu = torch.tensor(x), torch.tensor(u)
    theta = tp(*torch.tensor(th).T)
    loc = tlin.linearize_discrete(tsys, tx, tu, 0.05, theta, integrator)
    d = tlin.affine_residual(tsys, tx, tu, loc, 0.05, theta, integrator)
    np.testing.assert_array_equal(loc.C.numpy(), jc)
    return (ja, jb, jd), (loc.A.numpy(), loc.B.numpy(), d.numpy())


@pytest.mark.parametrize("integrator", ["rk4", "rk4_matlab"])
@pytest.mark.parametrize("name", list(PLANTS))
def test_linearize_discrete_matches_jax(name, integrator):
    """The Jacobians A = dF/dx, B = dF/du of the one-step map and the
    affine offset d = F(x, u) - A x - B u at 8 points with per-point
    parameters, within 1e-12 of JAX's ``jacfwd`` under ``vmap`` (the
    tanks' exact discrete map ignores the integrator); the batched
    ``batch_linearize_discrete`` is the same call, under
    ``torch.inference_mode()`` too (as the local-linear loop calls it)."""
    x, u, th = points(name)
    for j, t, what in zip(*both_linearize(name, x, u, th, integrator),
                          "ABd"):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12, err_msg=what)
    _, tsys, _, tp, _ = PLANTS[name]
    theta = tp(*torch.tensor(th).T)
    one = tlin.linearize_discrete(tsys, torch.tensor(x), torch.tensor(u),
                                  0.05, theta, integrator)
    with torch.inference_mode():
        many = tlin.batch_linearize_discrete(tsys, torch.tensor(x),
                                             torch.tensor(u), 0.05, theta,
                                             integrator)
    for a, b in zip(one, many):
        assert torch.equal(a, b)


def test_linearize_continuous_matches_jax():
    """(A_c, B_c) of the Duffing and VDP vector fields at 8 points within
    1e-12 of JAX's; a discrete plant has no vector field to linearize."""
    for name in ("duffing", "vanderpol"):
        jsys, tsys, jp, tp, _ = PLANTS[name]
        x, u, th = points(name, seed=2)
        ja, jb = (np.asarray(v) for v in jax.vmap(
            lambda xx, uu, t: jlin.linearize_continuous(jsys, xx, uu,
                                                        jp(*t)))(
            jnp.asarray(x), jnp.asarray(u), jnp.asarray(th)))
        ta, tb = tlin.linearize_continuous(tsys, torch.tensor(x),
                                           torch.tensor(u),
                                           tp(*torch.tensor(th).T))
        np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="vector field"):
        tlin.linearize_continuous(tlib.TANK, torch.ones(1, 2),
                                  torch.ones(1, 1))


def test_tank_jacobian_at_the_kinks_matches_jax():
    """The tank's clamps at their kinks: where the next level is exactly
    0 (x1 = 0.25, u = 0 at the nominal c1 = 0.5) the outer clamp's
    derivative is 0.5, ``jnp.maximum``'s rule at a tie, in both packages;
    at an empty tank (x2 = 0) the square root's derivative is infinite
    and the Jacobian carries the same inf / NaN entries as JAX's."""
    x = np.array([[0.25, 1.0], [1.0, 0.0], [0.25, 0.0]])
    u = np.zeros((3, 1))
    th = np.tile(np.array(jlib.TANK.theta0), (3, 1))
    (ja, jb, _), (ta, tb, _) = both_linearize("tank", x, u, th, "rk4")
    assert ja[0, 0, 0] == 0.5 * (1 - 0.5 * 0.5 / np.sqrt(0.25))
    for t, j in ((ta, ja), (tb, jb)):
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        ok = np.isfinite(j)
        np.testing.assert_allclose(t[ok], j[ok], rtol=0, atol=1e-15)


def test_constant_augmented_and_the_affine_model_are_exact():
    """psi(x) = [x; 1] as JAX's; [x+; 1] = A' [x; 1] + B' u reproduces
    x+ = A x + B u + d exactly, C' [x; 1] = x, and the augmented model
    equals JAX's ``affine_augmented_model`` bit for bit (batched)."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 3, 2))
    d, x, u = (rng.normal(size=(4, k)) for k in (3, 3, 2))
    lift = constant_augmented(3)
    assert lift.nlift == 4 and lift.n == 3
    z = lift(torch.tensor(x))
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jax.vmap(j_constant_augmented(3))(
            jnp.asarray(x))))
    aug = tll.affine_augmented_model(
        TModel(torch.tensor(a), torch.tensor(b),
               torch.eye(3, dtype=torch.float64).expand(4, 3, 3)),
        torch.tensor(d))
    z_next = (aug.A @ z.unsqueeze(-1) + aug.B @ torch.tensor(u).unsqueeze(-1)
              ).squeeze(-1).numpy()
    want = np.einsum("bij,bj->bi", a, x) + np.einsum("bij,bj->bi", b, u) + d
    np.testing.assert_allclose(z_next[:, :3], want, rtol=1e-12)
    assert (z_next[:, 3] == 1.0).all()
    np.testing.assert_array_equal(
        (aug.C @ z.unsqueeze(-1)).squeeze(-1).numpy(), x)
    jaug = jax.vmap(lambda aa, bb, dd: jll.affine_augmented_model(
        JModel(aa, bb, jnp.eye(3)), dd))(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(d))
    for t, j in zip(aug, jaug):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_local_linear_loop_matches_jax():
    """The local-linearization loop on the flagship's Duffing plant and
    MPC weights (horizon 10, the kernel route: its plain version on CPU
    tensors), 6 scenarios with per-scenario parameters over 20 float64
    steps through the switch at 10, against JAX's loop under ``vmap``:
    x and u within 1e-9 in every scenario and step; the logged reference
    and the QP residual; no kernel launch on the CPU; |u| within the
    box."""
    cfgs = []
    for C in (JC, TC):
        cfg = C.duffing_nn_preset()
        cfg.steps, cfg.dtype, cfg.switch_step = 20, "float64", 10
        cfg.mpc.horizon, cfg.mpc.qp_backend = 10, "pallas"
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jsys = jlib.DUFFING
    jdict = j_constant_augmented(jsys.n)
    jparams = j_mpc_params(jcfg, jdict, jsys)
    jloop = jll.make_local_linear_loop(
        jsys, j_engine_config(jcfg),
        j_ref_fn(jcfg, jdict, jparams.q_block.shape[0], jnp.float64))
    rng = np.random.default_rng(4)
    b = 6
    x0 = rng.uniform(-2.0, 2.0, size=(b, 2))
    th0 = np.array(jsys.theta0) * (1 + rng.uniform(-.15, .15, (b, 3)))
    th1 = np.array(jsys.theta1) * (1 + rng.uniform(-.15, .15, (b, 3)))
    jlog = jax.jit(jax.vmap(lambda x, t0, t1: jloop(
        jparams, x, jlib.DuffingParams(*t0), jlib.DuffingParams(*t1))[1]))(
        jnp.asarray(x0), jnp.asarray(th0), jnp.asarray(th1))
    loop, params = build_local_linear(tcfg, device="cpu")
    launches = box_admm.launches
    carry, log = tll.run_local_linear_batch(
        loop, replicate(params, b), torch.tensor(x0),
        tlib.DuffingParams(*torch.tensor(th0.T)),
        tlib.DuffingParams(*torch.tensor(th1.T)))
    assert box_admm.launches == launches
    assert log.x.shape == (b, 20, 2) and log.u.shape == (b, 20, 1)
    for k in ("x", "u"):
        np.testing.assert_allclose(getattr(log, k).numpy(),
                                   np.asarray(getattr(jlog, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(log.r.numpy(), np.asarray(jlog.r), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(log.qp_primal_res.numpy(),
                               np.asarray(jlog.qp_primal_res), rtol=0,
                               atol=1e-8)
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
    assert carry.cert == () and carry.warm_y == ()


def shooting_problem(seed=3, b=4, nz=3, py=2, np_horizon=6):
    """B stable random models (spectral radius 0.8), anchors and
    references."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, nz, nz))
    a *= 0.8 / np.abs(np.linalg.eigvals(a)).max(-1)[:, None, None]
    model = (a, rng.normal(size=(b, nz, 1)), rng.normal(size=(b, py, nz)))
    z0 = rng.uniform(-1.0, 1.0, size=(b, nz))
    r = rng.uniform(-1.0, 1.0, size=(b, np_horizon, py))
    return model, z0, r


@pytest.mark.parametrize("track_lifted,offset", [(False, False),
                                                 (True, True)])
def test_shooting_cost_matches_jax(track_lifted, offset):
    """The shooting cost of 4 scenarios (Nc = 4 moves, the tail holding
    the last over Np = 6; output or lifted tracking, with and without an
    affine offset d) within 1e-12 relative of JAX's under ``vmap``."""
    model, z0, r = shooting_problem(py=3 if track_lifted else 2)
    rng = np.random.default_rng(8)
    u_seq = rng.uniform(-2.0, 2.0, size=(4, 4, 1))
    d = rng.normal(size=z0.shape) if offset else None
    want = np.asarray(jax.vmap(
        lambda uu, aa, bb, cc, zz, rr, dd: jshoot.shooting_cost(
            uu, JModel(aa, bb, cc), zz, rr, 6, track_lifted,
            d=dd if offset else None))(
        *(jnp.asarray(v) for v in (u_seq, *model, z0, r)),
        jnp.asarray(d if offset else z0)))
    got = tshoot.shooting_cost(
        torch.tensor(u_seq), TModel(*(torch.tensor(v) for v in model)),
        torch.tensor(z0), torch.tensor(r), 6, track_lifted,
        d=torch.tensor(d) if offset else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_shooting_pgd_matches_jax():
    """``solve_shooting_pgd``, 200 projected Nesterov steps on 4
    scenarios within |u| <= 0.5 (the box binds), within 1e-9 of JAX's
    under ``vmap``; under ``torch.inference_mode()`` too."""
    model, z0, r = shooting_problem()
    cfg = tshoot.PGDConfig(iters=200, lr=1e-3)
    want = np.asarray(jax.vmap(
        lambda aa, bb, cc, zz, rr: jshoot.solve_shooting_pgd(
            JModel(aa, bb, cc), zz, rr, 4, 6, -0.5, 0.5,
            jshoot.PGDConfig(*cfg)))(
        *(jnp.asarray(v) for v in (*model, z0, r))))
    assert (np.abs(want) == 0.5).any()
    args = (TModel(*(torch.tensor(v) for v in model)), torch.tensor(z0),
            torch.tensor(r), 4, 6, -0.5, 0.5, cfg)
    with torch.inference_mode():
        got = tshoot.solve_shooting_pgd(*args)
    assert got.shape == (4, 4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
