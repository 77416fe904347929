"""The carried and the bf16 KKT inverses of koopmanx_torch (ROADMAP L3)
against the JAX package: ``ops/linalg.ns_tracking_inverse`` with its
keep-or-restart safeguard, the carried inverse in the batched loop, in
``run_resumable`` and in the serving controllers (a masked fleet reset
re-anchors per plant), ``ADMMConfig.kkt_bf16`` in ``solve_box_qp`` and in
the loop, and the two refusals. float64 on the CPU unless named; inputs
from numpy with a seed."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.control import qp as jqp  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.ops import linalg as jlinalg  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.control import qp as tqp  # noqa: E402
from koopmanx_torch.convert import (  # noqa: E402
    controller_state_from_numpy,
    controller_state_to_numpy,
    pipeline_from_numpy,
)
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.engine.controller import (  # noqa: E402
    BatchedController,
    Controller,
)
from koopmanx_torch.engine.loop import run_batch as t_run_batch  # noqa: E402
from koopmanx_torch.ops import linalg as tlinalg  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.run import (  # noqa: E402
    build_pipeline,
    replicate,
    run_resumable,
    run_single,
)
from koopmanx_torch.systems.base import as_params, make_step  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_controller import _drive, _drive_jax, _small  # noqa: E402
from test_torch_vdp import arrays_from_jax, scenarios  # noqa: E402

F64 = torch.float64
BATCH, STEPS, SWITCH, REFINE, REANCHOR = 16, 40, 20, 3, 16
DUFFING = ([-0.5, 1.0, -1.0], [-5.0, 2.0, -0.5])
ENCODER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "duffing_kmae_encoder.mat")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---- ns_tracking_inverse ----

def _spd(rng, n, batch=()):
    a = rng.normal(size=batch + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _carries(rng, k, kind):
    """A carried inverse of ``k`` (n, n): 'warm' (the exact inverse of k
    before a 1e-3 diagonal drift, tests/test_kkt_refine.py:31-46), 'nan',
    or 'adversarial' (I - K X = 1.2 w w': spectral radius 1.2 with a small
    Frobenius residual, tests/test_kkt_refine.py:100-116)."""
    n = k.shape[-1]
    if kind == "warm":
        drift = k - 1e-3 * np.diag(rng.normal(size=n))
        return np.linalg.inv(drift)
    if kind == "nan":
        return np.full((n, n), np.nan)
    w = np.zeros(n)
    w[0] = 1.0
    return np.linalg.inv(k) @ (np.eye(n) - 1.2 * np.outer(w, w))


def _decision(lib, k, x_prev):
    """The safeguard's keep decision per matrix, in each package's own
    arithmetic (its norms as ``ns_tracking_inverse`` takes them)."""
    if lib is jnp:
        r = jnp.eye(k.shape[-1]) - k @ x_prev
        e0 = jnp.sqrt(jnp.sum(r * r, axis=(-2, -1)))
        e1 = jnp.sqrt(jnp.sum((r @ r) ** 2, axis=(-2, -1)))
        return np.asarray(jnp.isfinite(e1) & ((e0 < 0.95) | (e1 < 0.7 * e0)))
    r = torch.eye(k.shape[-1], dtype=k.dtype) - k @ x_prev
    e0 = torch.sqrt((r * r).sum((-2, -1)))
    e1 = torch.sqrt(((r @ r) ** 2).sum((-2, -1)))
    return (torch.isfinite(e1) & ((e0 < 0.95) | (e1 < 0.7 * e0))).numpy()


@pytest.mark.parametrize("kind", ["warm", "nan", "adversarial", "mixed"])
def test_ns_tracking_inverse_matches_jax(kind):
    """16 x 16 matrices with each kind of carry, and a (64, 20, 20) batch
    mixing all three: the port against JAX's ``ns_tracking_inverse``
    (``vmap``-ed per matrix) within 1e-12 of the largest entry, with the
    same keep-or-restart decision per matrix; the warm carry is kept, the
    NaN and adversarial ones restart, and every result is finite and
    symmetric."""
    rng = np.random.default_rng({"warm": 1, "nan": 2, "adversarial": 7,
                                 "mixed": 11}[kind])
    if kind == "mixed":
        k = _spd(rng, 20, (64,))
        kinds = (["warm", "nan", "adversarial"] * 22)[:64]
        x_prev = np.stack([_carries(rng, k[i], kinds[i]) for i in range(64)])
    else:
        k = _spd(rng, 16, (1,))
        kinds = [kind]
        x_prev = _carries(rng, k[0], kind)[None]
    jfn = jax.vmap(lambda a, x: jlinalg.ns_tracking_inverse(a, x, REFINE))
    want = np.asarray(jfn(jnp.asarray(k), jnp.asarray(x_prev)))
    tk, tx = torch.tensor(k), torch.tensor(x_prev)
    got = tlinalg.ns_tracking_inverse(tk, tx, REFINE).numpy()
    keep = _decision(torch, tk, tx)
    np.testing.assert_array_equal(keep, _decision(jnp, jnp.asarray(k),
                                                  jnp.asarray(x_prev)))
    np.testing.assert_array_equal(keep, [c == "warm" for c in kinds])
    assert np.isfinite(got).all()
    scale = np.abs(want).max((-2, -1), keepdims=True)
    err = np.abs(got - want)
    assert (err <= 1e-12 * scale).all(), err.max()
    np.testing.assert_array_equal(got, np.swapaxes(got, -1, -2))


def test_carried_inverse_per_plant_select():
    """Per-plant steps (the fleet's clocks after a masked reset): the
    plants on an anchor step get the exact inverse, the others the
    Newton-Schulz refinement, each exactly as its int-step branch gives
    it; all on the anchor step, or none, runs one branch only."""
    rng = np.random.default_rng(3)
    k = torch.tensor(_spd(rng, 20, (4,)))
    prev = torch.tensor(np.stack([_carries(rng, k[i].numpy(), "warm")
                                  for i in range(4)]))
    cfg = tcore.EngineConfig(horizon=20, qp_kkt_refine=REFINE,
                             qp_kkt_reanchor=REANCHOR)
    exact = tcore.carried_kkt_inverse(cfg, k, prev, 0)
    tracked = tcore.carried_kkt_inverse(cfg, k, prev, 5)
    assert not torch.equal(exact, tracked)
    steps = torch.tensor([0, 5, 32, 17])
    got = tcore.carried_kkt_inverse(cfg, k, prev, steps)
    for i, due in enumerate([True, False, True, False]):
        assert torch.equal(got[i], (exact if due else tracked)[i])
    for steps, want in ((torch.tensor([16, 0, 48, 32]), exact),
                        (torch.tensor([1, 2, 3, 4]), tracked)):
        assert torch.equal(tcore.carried_kkt_inverse(cfg, k, prev, steps),
                           want)


# ---- the carried and bf16 inverses in the loop ----

def _flagship(C, steps=STEPS, dtype="float64", **mpc):
    """``flagship_config`` (the port's; the JAX package's bench overrides
    of ``duffing_nn_preset``) narrowed to hidden 16, 20 x 20 data, the
    switch at ``SWITCH``, horizon 20, on the plain route, with ``mpc``
    overrides."""
    cfg = C.duffing_nn_preset()
    cfg.steps, cfg.dtype, cfg.switch_step = steps, dtype, SWITCH
    cfg.data = C.DataConfig(n_step=20, n_traj=20)
    cfg.lift = C.LiftConfig(kind="mlp", nlift=8, hidden=16)
    cfg.mpc.horizon, cfg.mpc.qp_backend = 20, "xla"
    for k, v in mpc.items():
        setattr(cfg.mpc, k, v)
    return cfg


def _run_both(jcfg, tcfg, batch=BATCH):
    """The JAX pipeline of ``jcfg`` carried into the port under ``tcfg``;
    JAX ``run_batch`` from x0 and from x0 moved one ulp up and down, and
    the port's loop, over the same scenarios. Returns (JAX logs, the
    port's carry and log, the port's pipeline)."""
    jpipe = j_build_pipeline(jcfg)
    dtype = F64 if tcfg.dtype == "float64" else torch.float32
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), tcfg, device="cpu",
                               dtype=dtype)
    x0, th0, th1 = scenarios(*DUFFING, batch=batch)
    np_dt = np.float64 if dtype == F64 else np.float32
    x0, th0, th1 = (a.astype(np_dt) for a in (x0, th0, th1))
    rep = lambda v: jnp.broadcast_to(v, (batch,) + v.shape)
    jrun = jax.jit(lambda x: j_run_batch(
        jpipe.closed_loop, jax.tree_util.tree_map(rep, jpipe.params), x,
        jax.tree_util.tree_map(rep, jpipe.model0),
        jax.tree_util.tree_map(rep, jpipe.rls0),
        JDuffing(*jnp.asarray(th0.T)), JDuffing(*jnp.asarray(th1.T)))[1])
    jlogs = [jrun(jnp.asarray(x)) for x in (
        x0, np.nextafter(x0, np_dt(9)), np.nextafter(x0, np_dt(-9)))]
    launches = box_admm.launches
    carry, log = t_run_batch(
        pipe.closed_loop, replicate(pipe.params, batch), torch.tensor(x0),
        replicate(pipe.model0, batch), replicate(pipe.rls0, batch),
        TDuffing(*torch.tensor(th0.T)), TDuffing(*torch.tensor(th1.T)))
    assert box_admm.launches == launches  # CPU tensors: the plain version
    return jlogs, carry, log, pipe


def _held(jlogs, log, tol=1e-9):
    """x and u within ``tol`` in every scenario and step, or ten times the
    JAX package's own divergence from one ulp of x0 there, where larger
    (the scratch RLS amplifies round-off through the switch). Returns how
    many entries needed the floor."""
    jlog, *floors = jlogs
    over = 0
    for k in ("x", "u"):
        ref = np.asarray(getattr(jlog, k))
        diff = np.abs(getattr(log, k).numpy() - ref).max(-1)  # (B, T)
        floor = np.maximum.accumulate(np.max(
            [np.abs(np.asarray(getattr(f, k)) - ref).max(-1) for f in floors],
            axis=0), axis=1)
        assert (diff <= np.maximum(tol, 10.0 * floor)).all(), (
            k, diff.max(), floor.max())
        over += int((diff > tol).sum())
    return over


@pytest.fixture(scope="module")
def carried_loop():
    mpc = dict(qp_kkt_refine=REFINE, qp_kkt_reanchor=REANCHOR)
    return _run_both(_flagship(JC, **mpc), _flagship(TC, **mpc))


def test_carried_loop_matches_jax_run_batch(carried_loop):
    """16 scenarios x 40 steps through the switch at 20, refine 3,
    re-anchor 16, plain route, float64: x and u against JAX ``run_batch``
    within 1e-9, or ten times JAX's own one-ulp-of-x0 floor where the
    scratch RLS amplifies round-off. The floor applies: within the first
    16 steps JAX moves itself by up to 9.2e-10 in x and 1.9e-8 in u from
    one ulp of x0 (the exact-inverse loop of the same config alike), and
    the port is 1.5e-9 and 3.0e-8 from JAX there. The carry holds a
    finite, symmetric inverse."""
    jlogs, carry, log, _ = carried_loop
    assert _held(jlogs, log) > 0  # the floor is needed, as stated
    inv = carry.kkt_inv
    assert inv.shape == (BATCH, 20, 20) and torch.isfinite(inv).all()
    assert torch.equal(inv, inv.transpose(-1, -2))
    assert float(log.u.abs().max()) <= 2.0


def test_carried_loop_resumes_mid_period():
    """``run_resumable`` cut at step 13 (chunks of 13: the anchors at 16
    and 32 fall inside chunks, away from their starts) equals the uncut
    ``run_single``: the schedule reads the absolute step, and the carry
    hands the inverse across."""
    cfg = _flagship(TC, steps=39, qp_kkt_refine=REFINE,
                    qp_kkt_reanchor=REANCHOR)
    pipe = build_pipeline(cfg, device="cpu")
    carry, log = run_single(pipe)
    carry2, log2 = run_resumable(pipe, 39, 13)
    for a, b in zip(tree_leaves((carry, log)), tree_leaves((carry2, log2))):
        assert torch.equal(a, b)


def test_carry_is_the_inverse_before_bf16_rounding():
    """With both options on, the loop carries the full-precision inverse
    (``koopmanx/engine/core.py:631-632``): the solver rounds its own copy,
    and a rounded carry would poison the tracker: after three steps the
    carry holds values that bfloat16 does not."""
    cfg = _flagship(TC, steps=3, qp_kkt_refine=REFINE, qp_kkt_bf16=True)
    carry, log = run_single(build_pipeline(cfg, device="cpu"))
    inv = carry.kkt_inv
    assert not torch.equal(inv.to(torch.bfloat16).to(inv.dtype), inv)
    assert torch.isfinite(log.u).all()


def test_box_qp_bf16_matches_jax():
    """``solve_box_qp`` with ``kkt_bf16``, f32, fed the same f32 inverse
    (and inverting for itself): the port against ``vmap`` of JAX's within
    1e-6 of max(1, |x|); the rounding is JAX's (round to nearest even)."""
    rng = np.random.default_rng(5)
    b, n = 32, 20
    p = _spd(rng, n, (b,)).astype(np.float32)
    q = rng.normal(size=(b, n)).astype(np.float32)
    lo, hi = -np.ones((b, n), np.float32), np.ones((b, n), np.float32)
    cfg_j = jqp.ADMMConfig(iters=60, rho=0.1, kkt_bf16=True, kkt_block=4)
    cfg_t = tqp.ADMMConfig(iters=60, rho=0.1, kkt_block=4, kkt_bf16=True)
    tp = torch.tensor(p)
    kkt_inv = tlinalg.spd_inverse(tqp.box_kkt(tp, cfg_t), block=4)
    rounded = tqp.bf16_rounded(kkt_inv, cfg_t)
    np.testing.assert_array_equal(
        rounded.numpy(), np.asarray(jnp.asarray(kkt_inv.numpy()).astype(
            jnp.bfloat16).astype(jnp.float32)))
    for inv in (kkt_inv, None):
        axes = (0, 0, 0, 0, None if inv is None else 0)
        jsol = jax.vmap(lambda pp, qq, l, h, ki: jqp.solve_box_qp(
            pp, qq, l, h, cfg_j, kkt_inv=ki), in_axes=axes)(
            *(jnp.asarray(a) for a in (p, q, lo, hi)),
            None if inv is None else jnp.asarray(inv.numpy()))
        tsol = tqp.solve_box_qp(tp, torch.tensor(q), torch.tensor(lo),
                                torch.tensor(hi), cfg_t, kkt_inv=inv)
        want = np.asarray(jsol.x)
        err = np.abs(tsol.x.numpy() - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= 1e-6, err.max()


def _encoder_duffing(C, steps=30, dtype="float64", **mpc):
    """tests/test_engine.py's ``small_duffing_cfg``: ``duffing_nn_preset``
    with 40 x 40 data and the shipped encoder (the artifact both packages
    fall back to), with ``mpc`` overrides."""
    cfg = C.duffing_nn_preset()
    cfg.steps, cfg.dtype = steps, dtype
    cfg.data = C.DataConfig(n_step=40, n_traj=40)
    cfg.lift = C.LiftConfig(kind="mlp", nlift=8, weights_path=ENCODER)
    for k, v in mpc.items():
        setattr(cfg.mpc, k, v)
    return cfg


def test_bf16_loop_tracks_and_matches_jax():
    """``qp_kkt_bf16`` on tests/test_engine.py:355-371's loop: 30 f32
    steps stay within 0.05 in x of the port's own f32 loop (that test's
    bound); in float64 over 8 scenarios the port against JAX's bf16 loop
    within 1e-9, or ten times JAX's one-ulp-of-x0 floor. x holds 1e-9
    flat (2.6e-10); u needs the floor from step 12 (3.2e-9 against a
    floor of 2.8e-8), as the same loop without bf16 does (6.7e-8 against
    5.8e-7): the loop's own round-off growth, not a flipped bf16
    rounding."""
    logs = [run_single(build_pipeline(
        _encoder_duffing(TC, dtype="float32", qp_kkt_bf16=bf16),
        device="cpu"))[1] for bf16 in (False, True)]
    assert torch.isfinite(logs[1].x).all()
    assert float((logs[1].x - logs[0].x).abs().max()) < 0.05
    jlogs, _, log, _ = _run_both(_encoder_duffing(JC, qp_kkt_bf16=True),
                                 _encoder_duffing(TC, qp_kkt_bf16=True),
                                 batch=8)
    _held(jlogs, log)
    np.testing.assert_allclose(log.x.numpy(), np.asarray(jlogs[0].x), rtol=0,
                               atol=1e-9)


# ---- the serving controllers ----

def _refine_cfg(C):
    cfg = _small(C, "duffing", switch_step=15, mode="rls_sqrt", ridge=1e-6,
                 dither=0.02)
    cfg.mpc.qp_kkt_refine, cfg.mpc.qp_kkt_reanchor = REFINE, 8
    return cfg


def test_controller_with_refine_matches_jax_controller():
    """The port's Controller with the carried inverse (re-anchor 8) on the
    JAX pipeline carried across, against the JAX Controller over 30
    float64 calls: x and u within 1e-9. Then the JAX controller's state
    at call 12, its ``kkt_inv`` included, carried across by ``convert``:
    bit for bit through ``controller_state_to_numpy`` and back, and on to
    JAX's inputs within 1e-9."""
    jpipe = j_build_pipeline(_refine_cfg(JC))
    jxs, jus, kept = _drive_jax(jpipe, 30, keep_state_at=12)
    cfg = _refine_cfg(TC)
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), cfg, device="cpu",
                               dtype=F64)
    xs, us = _drive(pipe, 30)
    np.testing.assert_allclose(xs, jxs, rtol=0, atol=1e-9)
    np.testing.assert_allclose(us, jus, rtol=0, atol=1e-9)
    arrays = {
        "model": tuple(kept.model), "rls": kept.rls._asdict(),
        "u_prev": kept.u_prev, "warm_x": kept.warm_x, "warm_y": kept.warm_y,
        "z_prev": kept.z_prev, "x_prev": kept.x_prev,
        "have_prev": kept.have_prev, "res_ema": kept.res_ema,
        "cert": kept.cert or None, "kkt_inv": kept.kkt_inv,
    }
    assert np.asarray(kept.kkt_inv).shape == (10, 10)
    state = controller_state_from_numpy(arrays, cfg, device="cpu", dtype=F64)
    assert state.kkt_inv.shape == (1, 10, 10)
    np.testing.assert_array_equal(state.kkt_inv[0].numpy(), kept.kkt_inv)
    back = controller_state_from_numpy(controller_state_to_numpy(state), cfg,
                                       device="cpu", dtype=F64)
    for u, v in zip(tree_leaves(state), tree_leaves(back), strict=True):
        assert torch.equal(u, v)
    ctrl = Controller.from_pipeline(pipe)
    ctrl.state, ctrl._k = state, np.array([12])
    us = [ctrl.step(torch.tensor(x)).numpy() for x in jxs[12:]]
    np.testing.assert_allclose(np.stack(us), jus[12:], rtol=0, atol=1e-9)


def test_masked_reset_reanchors_per_plant():
    """A fleet of 4 with the carried inverse (re-anchor 8): 12 calls, then
    plants 0 and 2 reset (their inverses back to the seed, their clocks to
    0), so the fleet's steps differ per plant. Over the next 12 calls each
    plant equals, bit for bit, a fleet of copies of it whose clocks all
    read its own (the int path, one branch a step)."""
    cfg = _refine_cfg(TC)
    pipe = build_pipeline(cfg, device="cpu")
    system = get_system(cfg.system)
    plant = make_step(system, pipe.engine_cfg.h)
    theta = as_params(system.theta0, F64, "cpu")
    fleet = BatchedController.from_pipeline(pipe, 4)
    x = torch.tensor(np.random.default_rng(9).uniform(-2, 2, (4, 2)))
    for _ in range(12):
        x = plant(x, fleet.step(x), theta)
    seed = fleet._init.kkt_inv
    fleet.reset(mask=np.array([True, False, True, False]))
    assert fleet.clocks.tolist() == [0, 12, 0, 12]
    assert torch.equal(fleet.state.kkt_inv[0], seed[0])
    assert not torch.equal(fleet.state.kkt_inv[1], seed[1])
    twins = []
    for i in range(4):
        twin = BatchedController.from_pipeline(pipe, 4)
        twin.state = tree_map(lambda t: t[i:i + 1].expand_as(t).clone(),
                              fleet.state)
        twin._k = np.full(4, fleet.clocks[i])
        twins.append(twin)
    for _ in range(12):
        u = fleet.step(x)
        for i, twin in enumerate(twins):
            assert torch.equal(twin.step(x[i:i + 1].expand(4, 2))[0], u[i])
        x = plant(x, u, theta)
    assert torch.isfinite(fleet.state.kkt_inv).all()


# ---- refusals ----

def test_refine_refuses_the_kernel_route_and_general_rows():
    """As in the JAX package: the carried inverse with
    ``qp_backend='pallas'`` raises when the loop is built; with general
    inequality rows (the tank's applied window as rows, or the flagship's
    state box) the first control solve raises."""
    cfg = _flagship(TC, steps=2, qp_kkt_refine=REFINE)
    cfg.mpc.qp_backend = "pallas"
    with pytest.raises(ValueError, match="qp_kkt_refine"):
        build_pipeline(cfg, device="cpu")
    tank = TC.tank_bench_config(steps=2, qp_backend="xla")
    tank.data = dataclasses.replace(tank.data, n_step=20, n_traj=20)
    tank.mpc.applied_bounds = "rows"
    box = _flagship(TC, steps=2, state_bounds=(-1.05, 1.05))
    for cfg in (tank, box):
        cfg.mpc.qp_kkt_refine = REFINE
        with pytest.raises(ValueError, match="box-only QP fast path"):
            run_single(build_pipeline(cfg, device="cpu"))
