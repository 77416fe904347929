"""The LMI terminal synthesis of koopmanx_torch (``control/lmi.py``)
against the JAX package's: the three bodies of ``solve_terminal_lmi``
(``method='auto'``, its barrier polish, ``method='penalized'``), the
batch against single calls, the NaN-faithful eigenvalue functions, and
the ``terminal_mode='lmi'`` Revise_2 loop against JAX ``run_batch``.
float64 on the CPU, inputs from numpy with a seed (the instances of
``tests/test_lmi.py``); the JAX calls run under ``jax.jit``, and under
``jax.vmap`` where the port takes a batch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.control import dare as jdare  # noqa: E402
from koopmanx.control import lmi as jlmi  # noqa: E402
from koopmanx.ops.linalg import spd_inverse as j_spd_inverse  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch.control import lmi as tlmi  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

from test_torch_revise2 import PLANTS, assert_monitors_match, configs  # noqa: E402
from test_torch_vdp import assert_logs_match, run_both  # noqa: E402

R = np.array([[0.01]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_model():
    """``tests/test_lmi.py::small_model``: a stable controllable lifted
    pair, nlift 3, with its weights and four anchors."""
    a = np.array([[0.9, 0.1, 0.0], [0.0, 0.85, 0.1], [0.05, 0.0, 0.8]])
    b = np.array([[0.1], [0.3], [0.05]])
    c = np.eye(3)[:2]
    q = np.diag([10.0, 10.0, 0.0])
    psis = np.array([[0.3, -0.2, 0.1], [0.1, 0.1, 0.0], [0.5, -0.4, 0.2],
                     [0.0, 0.0, 0.0]])
    return (a, b, c), q, psis


def duffing_like():
    """``tests/test_lmi.py::_duffing_like_model``: a Revise_2-scale pair,
    nlift 10, Q_lift = diag(10, 10, 0, ...), its anchor: the input bound
    binds at u_max = 2 and is slack at 30."""
    rng = np.random.default_rng(7)
    nlift = 10
    raw = rng.standard_normal((nlift, nlift))
    a = 0.92 * raw / np.abs(np.linalg.eigvals(raw)).max()
    b = 0.3 * rng.standard_normal((nlift, 1))
    c = np.zeros((2, nlift))
    c[:, :2] = np.eye(2)
    q = np.diag(np.concatenate([np.full(2, 10.0), np.zeros(nlift - 2)]))
    psi = np.random.default_rng(3).normal(0, 0.3, nlift)
    return (a, b, c), q, psi[None]


def ill_conditioned():
    """``tests/test_lmi.py::test_lmi_ill_conditioned_model``: eigenvalue
    spread ~1e4 and a weak input channel, nlift 6."""
    a = np.diag([0.999, 0.99, 0.9, 0.5, 0.1, 1e-4])
    a[0, 5] = 1e2
    b = np.array([[1e-3], [0.5], [0.2], [0.1], [0.05], [1e-4]])
    q = np.diag([10.0, 10.0, 0, 0, 0, 0])
    psi = np.array([[0.2, -0.1, 0.05, 0.0, 0.0, 0.01]])
    return (a, b, np.eye(6)[:2]), q, psi


INSTANCES = {"small": small_model, "binding": duffing_like,
             "ill_conditioned": ill_conditioned}


def jax_solve(model, q, psis, u_max, **kw):
    """JAX ``solve_terminal_lmi`` for each anchor of ``psis`` (one model),
    under ``jax.jit(jax.vmap(...))``, as numpy."""
    fn = jax.jit(jax.vmap(lambda psi: jlmi.solve_terminal_lmi(
        JModel(*(jnp.asarray(v) for v in model)), jnp.asarray(q),
        jnp.asarray(R), psi, u_max=u_max, **kw)))
    return jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(psis)))


def port_solve(model, q, psis, u_max, **kw):
    """The port's batched call, the model repeated for each anchor."""
    b = psis.shape[0]
    tm = TModel(*(torch.tensor(v).expand((b,) + v.shape) for v in model))
    return tlmi.solve_terminal_lmi(tm, torch.tensor(q), torch.tensor(R),
                                   torch.tensor(psis), u_max=u_max, **kw)


def jax_branch(model, q, psis, u_max, grid=12):
    """Which of the three results JAX's ``_solve_detuned_dare`` returns per
    anchor (0 the DARE point, 1 the detuned pair, 2 the fallback), from
    its candidate test (``lmi.py:503-511``) on JAX's own DARE."""
    a, b = (jnp.asarray(v) for v in model[:2])
    qj, rj = jnp.asarray(q), jnp.asarray(R)

    @jax.jit
    def ok(s, psi):
        p = jdare.solve_dare_doubling(a, b, qj, s * rj)
        k = -jdare.dlqr_gain(a, b, qj, s * rj, p)
        g = (psi @ p @ psi) * (1.0 + 1e-6)
        x1 = g * jnp.diag(k @ (j_spd_inverse(p, eps=1e-9) @ k.T))
        finite = jnp.all(jnp.isfinite(p)) & jnp.all(jnp.isfinite(k))
        return jnp.all(x1 <= u_max ** 2) & finite & (g >= 0)

    out = []
    for psi in jnp.asarray(psis):
        oks = [bool(ok(2.0 ** i, psi)) for i in range(grid + 1)]
        out.append(0 if oks[0] else (1 if any(oks[1:]) else 2))
    return np.array(out)


def assert_rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want)).max()
    scale = max(np.abs(np.nan_to_num(want)).max(), 1e-300)
    assert diff <= rtol * scale, (what, diff / scale)


@pytest.mark.parametrize("name,u_max", [("small", 2.0), ("binding", 2.0),
                                        ("binding", 30.0),
                                        ("ill_conditioned", 2.0)])
def test_lmi_auto_matches_jax(name, u_max):
    """``method='auto'``, the engine's: P, K, gamma and Q1 within 1e-9 of
    JAX's (relative to each one's largest entry), feasibility within
    1e-9 of the LMI scale, and the same branch per anchor (the DARE point
    where the input bound is slack, the detuned pair where it binds)."""
    model, q, psis = INSTANCES[name]()
    j = jax_solve(model, q, psis, u_max)
    t = port_solve(model, q, psis, u_max)
    for k in ("p", "k", "gamma", "q1"):
        assert_rel(getattr(t, k).numpy(), getattr(j, k), 1e-9, k)
    scale = max(1.0, float(np.abs(j.q1).max()), float(np.abs(j.gamma).max()))
    np.testing.assert_allclose(t.feasibility.numpy(), j.feasibility,
                               rtol=0, atol=1e-9 * scale)
    branch = jax_branch(model, q, psis, u_max)
    np.testing.assert_array_equal(t.branch.numpy(), branch)
    if name == "binding":
        assert branch.tolist() == ([1] if u_max == 2.0 else [0])


def test_lmi_polish_matches_jax():
    """``polish_iters=10`` on the binding instance: the barrier Newton's
    gamma within 1e-6 relative of JAX's, or within ten times JAX's own
    change when A moves by one ulp (the fixed-iteration Newton on an
    ill-conditioned barrier Hessian amplifies round-off: one ulp of A
    moves JAX's polished gamma by more than 1e-6 relative), where that
    is larger; the same accept decision (the polish improved on the
    family's gamma), a certified result (feasibility <= 1e-9)."""
    model, q, psis = duffing_like()
    fn = jax.jit(lambda a: jlmi.solve_terminal_lmi(
        JModel(a, *(jnp.asarray(v) for v in model[1:])), jnp.asarray(q),
        jnp.asarray(R), jnp.asarray(psis[0]), u_max=2.0, polish_iters=10))
    jg = float(fn(jnp.asarray(model[0])).gamma)
    floor = max(abs(float(fn(jnp.asarray(np.nextafter(model[0], s))).gamma)
                    - jg) for s in (9.0, -9.0))
    family = float(jax_solve(model, q, psis, 2.0).gamma[0])
    t = port_solve(model, q, psis, 2.0, polish_iters=10)
    tg = float(t.gamma[0])
    assert abs(tg - jg) <= max(1e-6 * jg, 10.0 * floor), (tg, jg, floor)
    assert (tg < family) == (jg < family) and jg < family
    assert float(t.feasibility[0]) <= 1e-9


@pytest.mark.parametrize("name", ["small", "binding"])
def test_lmi_penalized_matches_jax(name):
    """``method='penalized'``, 400 Adam steps and the Lyapunov correction:
    P, K and gamma within 1e-6 relative of JAX's, the sign of the
    feasibility residual equal (the binding instance surfaces its
    violation, > 1)."""
    model, q, psis = INSTANCES[name]()
    kw = dict(method="penalized", iters=400)
    j = jax_solve(model, q, psis, 2.0, **kw)
    t = port_solve(model, q, psis, 2.0, **kw)
    for k in ("p", "k", "gamma"):
        assert_rel(getattr(t, k).numpy(), getattr(j, k), 1e-6, k)
    np.testing.assert_array_equal(t.feasibility.numpy() > 0,
                                  j.feasibility > 0)
    assert t.branch is None
    if name == "binding":
        assert float(t.feasibility[0]) > 1.0


def test_lmi_batch_equals_single_calls():
    """A batch of 4 models (the binding instance's A scaled per scenario,
    each with its own anchor and bound) equals 4 unbatched calls, each
    field within 1e-12 relative; the unbatched call returns no batch
    axis."""
    (a, b, c), q, psis = duffing_like()
    rng = np.random.default_rng(11)
    scales = np.array([1.0, 0.97, 1.02, 0.9])
    psi = psis[0] * rng.uniform(0.5, 2.0, size=(4, 1))
    u_max = np.array([2.0, 30.0, 1.0, 5.0])
    batched = tlmi.solve_terminal_lmi(
        TModel(torch.tensor(scales[:, None, None] * a),
               torch.tensor(b).expand(4, -1, -1),
               torch.tensor(c).expand(4, -1, -1)),
        torch.tensor(q), torch.tensor(R), torch.tensor(psi),
        u_max=torch.tensor(u_max))
    for i in range(4):
        one = tlmi.solve_terminal_lmi(
            TModel(*(torch.tensor(v) for v in (scales[i] * a, b, c))),
            torch.tensor(q), torch.tensor(R), torch.tensor(psi[i]),
            u_max=float(u_max[i]))
        assert one.p.shape == a.shape
        for k in tlmi.LMIResult._fields:
            assert_rel(getattr(batched, k)[i].numpy(),
                       getattr(one, k).numpy(), 1e-12, k)
    assert len(set(batched.branch.tolist())) > 1


def test_eigenvalue_functions_are_nan_where_jax_is():
    """``_min_eig``, ``_eig_penalty`` and ``_lmi_feasibility`` give NaN for
    a matrix with a NaN entry, as JAX's do (torch's ``eigvalsh`` of such a
    matrix returns finite values or raises), and JAX's values elsewhere
    (1e-12); the whole solve on a model with a NaN entry in A gives the
    NaN pattern of JAX's result, and its finite neighbour in the batch
    its own result."""
    rng = np.random.default_rng(5)
    m = rng.normal(size=(4, 5, 5))
    m[1, 2, 2] = np.nan
    m[3, 0, 4] = np.inf
    tm = torch.tensor(m)
    for fn, jfn in ((tlmi._min_eig, jlmi._min_eig),
                    (lambda x: tlmi._eig_penalty(x, 0.3),
                     lambda x: jlmi._eig_penalty(x, 0.3))):
        want = np.asarray(jax.vmap(jfn)(jnp.asarray(m)))
        got = fn(tm).numpy()
        assert np.isnan(want[[1, 3]]).all()
        assert_rel(got, want, 1e-12, "eig")
    (a, b, c), q, psis = duffing_like()
    a_nan = np.stack([a, a])
    a_nan[1, 4, 4] = np.nan
    jfn = jax.jit(jax.vmap(lambda aa: jlmi.solve_terminal_lmi(
        JModel(aa, jnp.asarray(b), jnp.asarray(c)), jnp.asarray(q),
        jnp.asarray(R), jnp.asarray(psis[0]), u_max=2.0)))
    j = jax.tree_util.tree_map(np.asarray, jfn(jnp.asarray(a_nan)))
    t = tlmi.solve_terminal_lmi(
        TModel(torch.tensor(a_nan), torch.tensor(b).expand(2, -1, -1),
               torch.tensor(c).expand(2, -1, -1)), torch.tensor(q),
        torch.tensor(R), torch.tensor(psis).expand(2, -1), u_max=2.0)
    assert np.isnan(j.feasibility[1]) and np.isnan(t.feasibility[1].item())
    for k in ("p", "k", "gamma", "q1", "feasibility"):
        np.testing.assert_array_equal(np.isnan(getattr(t, k).numpy()),
                                      np.isnan(getattr(j, k)), k)
    for k in ("p", "k", "gamma", "q1"):
        assert_rel(getattr(t, k).numpy()[:1], getattr(j, k)[:1], 1e-9, k)
    np.testing.assert_allclose(t.feasibility.numpy()[0], j.feasibility[0],
                               rtol=0, atol=1e-9 * np.abs(j.q1[0]).max())


def test_lmi_terminal_loop_matches_jax_run_batch():
    """``revise2_duffing`` with ``terminal_mode='lmi'``, 4 scenarios over
    12 float64 steps through the switch, against JAX ``run_batch`` on one
    pipeline: x and u, and every Revise_2 monitor, per scenario and step
    at the tolerances of the DARE mode's test or within ten times JAX's
    own divergence from one ulp of x0 and of the initial A
    (``tests/test_torch_revise2.py``); ``cert_fresh`` equal. The held
    certificate is finite and the loop's |u| within the box."""
    jcfg, tcfg = configs("revise2_duffing", 12)
    for cfg in (jcfg, tcfg):
        cfg.mpc.terminal_mode = "lmi"
    jlogs, log, carry, pipe = run_both(jcfg, tcfg,
                                       PLANTS["duffing"], n=2,
                                       nudge_model=True)
    assert_logs_match(jlogs[:3], log)
    assert_monitors_match(jlogs, log)
    assert all(bool(torch.isfinite(t).all()) for t in carry.cert)
    assert float(log.u.abs().max()) <= tcfg.mpc.u_max
