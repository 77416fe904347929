"""Reverse-mode gradients through koopmanx_torch's closed loop against
``jax.grad`` over the JAX package's, on the same pipeline carried across
as numpy arrays (``convert.pipeline_from_numpy``); ``EngineConfig.remat``
(per-step checkpointing); the forward unchanged by grad mode; the kernel
route's refusal of autograd; two Adam steps of
``examples/tune_weights_torch.py`` against ``optax.adam``. float64 on the
CPU unless a test says otherwise."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control.qp import ADMMConfig, solve_box_qp_batch_kernel  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import build_pipeline as t_build_pipeline  # noqa: E402
from koopmanx_torch.run import replicate, with_engine_config  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402

from test_torch_vdp import arrays_from_jax  # noqa: E402

F64 = torch.float64
STEPS, BATCH = 30, 4
# the port's gradient against JAX's: relative GRAD_RTOL, or ten times
# JAX's own change when every x0 moves up by one ulp, where the loop
# amplifies round-off past that (the same arithmetic in other summation
# orders reaches the gradient through the 30 closed-loop steps)
GRAD_RTOL = 1e-8
REMAT_RTOL = 1e-12
ADAM_RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configure(cfg, lift_cls, data_cls, steps=STEPS):
    """The small Duffing loop of tests/test_torch_loop.py: horizon 10, a
    random-init MLP lift (hidden 16), data 20x20, the switch at half the
    run, f64; the plain QP route, the differentiable one in both
    packages."""
    cfg.steps = steps
    cfg.dtype = "float64"
    cfg.switch_step = steps // 2
    cfg.mpc.horizon = 10
    cfg.mpc.qp_backend = "xla"
    cfg.data = data_cls(n_step=20, n_traj=20)
    cfg.lift = lift_cls(kind="mlp", nlift=8, hidden=16)
    return cfg


@pytest.fixture(scope="module")
def pipes():
    jpipe = j_build_pipeline(_configure(JC.duffing_nn_preset(), JC.LiftConfig,
                                        JC.DataConfig))
    tpipe = pipeline_from_numpy(
        arrays_from_jax(jpipe),
        _configure(TC.duffing_nn_preset(), TC.LiftConfig, TC.DataConfig),
        device="cpu", dtype=F64)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def jax_single(pipes, jax_vg):
    """JAX's cost and gradient at log r = 0 from the pipeline's x_init and
    from every x0 moved up by one ulp."""
    x0 = np.asarray(pipes[0].x_init)
    (v, g), (_, g_nudged) = jax_vg(0.0, x0), jax_vg(0.0, _nudged(x0))
    return float(v), float(g), float(g_nudged)


def _scenarios():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2, 2, size=(BATCH, 2))
    th0 = np.array([-0.5, 1.0, -1.0]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    th1 = np.array([-5.0, 2.0, -0.5]) * (1 + rng.uniform(-.15, .15, (BATCH, 3)))
    return x0, th0, th1


def _nudged(x0):
    return np.nextafter(x0, np.inf)


def _settled_cost(x, r):
    """The cost of examples/tune_weights.py: the mean squared error of x1
    against r1 over the second half of the run (and every scenario)."""
    return ((x[..., STEPS // 2:, 0] - r[..., STEPS // 2:, 0]) ** 2).mean()


@pytest.fixture(scope="module")
def jax_vg(pipes):
    """``(log_r, x0) -> (cost, d cost / d log r)`` through
    ``jpipe.closed_loop`` on one scenario with ``r_block = exp(log_r) I``,
    jitted once."""
    jpipe, _ = pipes

    def loss(log_r, x0):
        p = jpipe.params._replace(r_block=jnp.exp(log_r) * jnp.eye(1))
        _, log = jpipe.closed_loop(p, x0, jpipe.model0, jpipe.rls0)
        return _settled_cost(log.x, log.r)

    vg = jax.jit(jax.value_and_grad(loss))
    return lambda log_r, x0: vg(jnp.asarray(log_r, jnp.float64),
                                jnp.asarray(x0))


def _jax_batch(jpipe, th0, th1):
    """``x0 -> (cost, d cost / d log r at 0)`` over JAX's vmapped
    ``run_batch`` on BATCH scenarios, jitted once."""
    rep = lambda v: jnp.broadcast_to(v, (BATCH,) + v.shape)
    jp = jax.tree_util.tree_map(rep, jpipe.params)
    model = jax.tree_util.tree_map(rep, jpipe.model0)
    rls = jax.tree_util.tree_map(rep, jpipe.rls0)
    th0 = JDuffing(*jnp.asarray(th0).T)
    th1 = JDuffing(*jnp.asarray(th1).T)

    def loss(log_r, x0):
        p = jp._replace(r_block=rep(jnp.exp(log_r) * jnp.eye(1)))
        _, log = j_run_batch(jpipe.closed_loop, p, x0, model, rls, th0, th1)
        return _settled_cost(log.x, log.r)

    vg = jax.jit(jax.value_and_grad(loss))
    return lambda x0: vg(jnp.asarray(0.0, jnp.float64), jnp.asarray(x0))


def _torch_grad(pipe, x0, theta=None, remat=False, dtype=F64):
    """(cost, d cost / d log r at 0) through the port's loop on the
    scenarios ``x0`` (B, n), on ``pipe`` (with ``remat`` set)."""
    if remat:
        pipe = with_engine_config(pipe, remat=True)
    b = x0.shape[0]
    log_r = torch.zeros((), dtype=dtype, requires_grad=True)
    p = replicate(pipe.params, b)
    p = p._replace(r_block=torch.exp(log_r) * torch.eye(1, dtype=dtype)
                   .expand(p.r_block.shape))
    th0, th1 = theta if theta is not None else (None, None)
    _, log = t_run_batch(pipe.closed_loop, p, x0, replicate(pipe.model0, b),
                         replicate(pipe.rls0, b), th0, th1)
    cost = _settled_cost(log.x, log.r)
    (grad,) = torch.autograd.grad(cost, log_r)
    return float(cost.detach()), float(grad)


def _tol(g_jax, g_nudged):
    """GRAD_RTOL of |g|, or ten times JAX's own one-ulp-of-x0 change."""
    return max(GRAD_RTOL * abs(g_jax), 10.0 * abs(g_nudged - g_jax))


@pytest.mark.parametrize("remat", [False, True])
def test_grad_matches_jax_single_scenario(pipes, jax_single, remat):
    """One scenario from the pipeline's x_init, 30 f64 steps with the
    switch at 15: the port's d cost / d log r (the settled cost, r = exp(log
    r)) against ``jax.grad`` over ``pipe.closed_loop`` (JAX's remat changes
    nothing in its gradient, so both port settings meet the same JAX
    value)."""
    _, tpipe = pipes
    jv, jg, jg_n = jax_single
    tv, tg = _torch_grad(tpipe, tpipe.x_init[None], remat=remat)
    assert np.isfinite(tg) and tg != 0.0
    assert abs(tv - jv) <= 1e-9 * abs(jv)
    assert abs(tg - jg) <= _tol(jg, jg_n), (tg, jg)


def test_grad_matches_jax_batch(pipes):
    """Four scenarios with their own x0 and plant parameters: the port's
    batched loop against ``jax.grad`` through JAX's vmapped ``run_batch``,
    the settled cost averaged over the scenarios too."""
    jpipe, tpipe = pipes
    x0, th0, th1 = _scenarios()
    jvg = _jax_batch(jpipe, th0, th1)
    (jv, jg), (_, jg_n) = jvg(x0), jvg(_nudged(x0))
    theta = (TDuffing(*torch.tensor(th0).T), TDuffing(*torch.tensor(th1).T))
    tv, tg = _torch_grad(tpipe, torch.tensor(x0), theta)
    assert np.isfinite(tg) and tg != 0.0
    assert abs(tv - float(jv)) <= 1e-9 * abs(float(jv))
    assert abs(tg - float(jg)) <= _tol(float(jg), float(jg_n)), (tg, float(jg))


def test_remat_equals_plain_graph(pipes):
    """``remat=True`` recomputes each step in the backward pass: the same
    gradient as the stored graph to REMAT_RTOL (in float64)."""
    _, tpipe = pipes
    x0, _, _ = _scenarios()
    _, g = _torch_grad(tpipe, torch.tensor(x0))
    _, g_remat = _torch_grad(tpipe, torch.tensor(x0), remat=True)
    assert abs(g_remat - g) <= REMAT_RTOL * abs(g)


def _small_duffing_f32(steps):
    """tests/test_engine.py's small_duffing_cfg in float32: the flagship
    preset with 40 x 40 data (its lift resolves to the in-repo encoder)."""
    cfg = TC.duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.data = TC.DataConfig(n_step=40, n_traj=40)
    return cfg


@pytest.mark.parametrize("remat", [False, True])
def test_grad_flows_through_closed_loop(remat):
    """The counterpart of tests/test_engine.py::
    test_grad_flows_through_closed_loop: the whole loop (encode -> QP
    build -> fixed-iteration ADMM -> plant -> RLS) is reverse-mode
    differentiable w.r.t. the controller weights in float32, with and
    without per-step checkpointing."""
    pipe = t_build_pipeline(_small_duffing_f32(40), device="cpu")
    _, g = _torch_grad(pipe, pipe.x_init[None], remat=remat,
                       dtype=torch.float32)
    assert np.isfinite(g)
    assert abs(g) > 0.0, "zero gradient: graph disconnected"


@pytest.mark.parametrize("requires_grad", [False, True])
def test_forward_unchanged_by_grad_mode(pipes, requires_grad):
    """Under grad mode the log is bit for bit the log under
    ``torch.inference_mode()``: with no input requiring grad the loop runs
    in inference mode itself; with one, it records the graph over the
    same arithmetic."""
    _, tpipe = pipes
    x0, _, _ = _scenarios()
    args = lambda: (replicate(tpipe.params, BATCH), torch.tensor(x0),
                    replicate(tpipe.model0, BATCH),
                    replicate(tpipe.rls0, BATCH))
    with torch.inference_mode():
        carry_ref, log_ref = tpipe.closed_loop(*args())
    params, x, model, rls = args()
    if requires_grad:
        x = x.clone().requires_grad_(True)
    carry, log = tpipe.closed_loop(params, x, model, rls)
    assert log.x.requires_grad == requires_grad
    for name, a, b in zip(log._fields, log, log_ref):
        assert torch.equal(a.detach(), b), name
    assert torch.equal(carry.x.detach(), carry_ref.x)


def _box_inputs(batch=3, nx=4):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((batch, nx, nx), generator=gen, dtype=F64)
    p = a @ a.transpose(-1, -2) + nx * torch.eye(nx, dtype=F64)
    q = torch.randn((batch, nx), generator=gen, dtype=F64)
    lo, hi = -torch.ones_like(q), torch.ones_like(q)
    return p, q, lo, hi


def test_kernel_route_refuses_autograd():
    """``box_admm`` and ``solve_box_qp_batch_kernel`` raise ValueError
    under autograd before any device branch (here on CPU tensors, which
    would take the differentiable plain version), and so does a closed
    loop on the kernel route given a ``log r`` that requires grad; under
    ``no_grad``, or with nothing requiring grad, they run."""
    p, q, lo, hi = _box_inputs()
    minv = torch.linalg.inv(p)
    rho = torch.ones(q.shape[0], dtype=F64)
    zeros = torch.zeros_like(q)
    q_grad = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="qp_backend='xla'"):
        box_admm(minv, q_grad, lo, hi, zeros, zeros, rho)
    with pytest.raises(ValueError, match="qp_backend='xla'"):
        solve_box_qp_batch_kernel(p, q_grad, lo, hi, ADMMConfig(iters=5))
    with torch.no_grad():
        box_admm(minv, q_grad, lo, hi, zeros, zeros, rho)
        solve_box_qp_batch_kernel(p, q_grad, lo, hi, ADMMConfig(iters=5))
    out = solve_box_qp_batch_kernel(p, q, lo, hi, ADMMConfig(iters=5))
    assert not out.x.requires_grad

    cfg = _configure(TC.duffing_nn_preset(), TC.LiftConfig, TC.DataConfig,
                     steps=3)
    cfg.mpc.qp_backend = "pallas"
    pipe = t_build_pipeline(cfg, device="cpu")
    with pytest.raises(ValueError, match="no gradient"):
        _torch_grad(pipe, pipe.x_init[None])


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tune_adam_steps_match_optax(pipes, jax_vg):
    """Two Adam steps of ``tune_weights_torch.tune`` (the example's settled
    cost through ``r_block = exp(log r) I``) against ``optax.adam(0.5)``
    over ``jax.grad`` of the JAX example's cost, on the same carried
    pipeline: ``log r`` after each step within ADAM_RTOL."""
    tune_mod = _example("tune_weights_torch")
    jpipe, tpipe = pipes
    iters = 2
    opt = optax.adam(tune_mod.LR)
    log_r = jnp.asarray(0.0, jnp.float64)
    state = opt.init(log_r)
    want = []
    for _ in range(iters):
        _, g = jax_vg(log_r, np.asarray(jpipe.x_init))
        updates, state = opt.update(g, state)
        log_r = optax.apply_updates(log_r, updates)
        want.append(float(log_r))

    got = tune_mod.tune(None, iters, pipe=tpipe)
    assert [rec["iter"] for rec in got] == [1, 2]
    for rec, w in zip(got, want):
        assert abs(rec["log_r"] - w) <= ADAM_RTOL * abs(w), (rec, w)
        assert np.isfinite(rec["grad"]) and rec["grad"] != 0.0
