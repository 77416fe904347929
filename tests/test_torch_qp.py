"""koopmanx_torch condensed QP, box ADMM and the kernel's plain version
against the JAX package (float64 unless stated)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.control import condensed as jc  # noqa: E402
from koopmanx.control import qp as jqp  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch.control import condensed as tc  # noqa: E402
from koopmanx_torch.control import qp as tqp  # noqa: E402
from koopmanx_torch.ops.box_admm import (  # noqa: E402
    box_admm,
    box_admm_reference,
    launch_shape,
)
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

B, NZ, M, PY, N = 5, 8, 1, 2, 10


def _models(rng):
    a = 0.1 * rng.normal(size=(B, NZ, NZ)) + 0.8 * np.eye(NZ)
    b = 0.3 * rng.normal(size=(B, NZ, M))
    c = 0.5 * rng.normal(size=(B, PY, NZ))
    return a, b, c


@pytest.mark.parametrize("method", ["dag", "scan"])
def test_prediction_matrices_match_jax(method):
    # products of up to N=10 8x8 matrices of norm ~1: 1e-10 is ~1e5 ulps
    a, b, c = _models(np.random.default_rng(0))
    ref = jax.vmap(lambda aa, bb, cc: jc.prediction_matrices(
        JModel(aa, bb, cc), N, None, method))(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(c))
    out = tc.prediction_matrices(
        TModel(torch.tensor(a), torch.tensor(b), torch.tensor(c)), N, None,
        method)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-10)


def test_condensed_qp_matches_jax():
    rng = np.random.default_rng(1)
    a, b, c = _models(rng)
    z0 = rng.normal(size=(B, NZ))
    yr = np.tile([1.0, 0.0], (B, N))
    q_block = np.stack([100.0 * np.eye(PY)] * B)
    r_block = np.stack([1e-4 * np.eye(M)] * B)

    def jfun(aa, bb, cc, z, y, qb, rb):
        pred = jc.prediction_matrices(JModel(aa, bb, cc), N)
        return jc.condensed_qp(pred, z, y, jc.weight_bar(qb, N),
                               jnp.kron(jnp.eye(N), rb), -2.0, 2.0)

    ref = jax.vmap(jfun)(*(jnp.asarray(v) for v in
                           (a, b, c, z0, yr, q_block, r_block)))
    t = torch.tensor
    pred = tc.prediction_matrices(TModel(t(a), t(b), t(c)), N)
    lo = torch.full((B, N * M), -2.0, dtype=torch.float64)
    out = tc.condensed_qp(pred, t(z0), t(yr), tc.weight_bar(t(q_block), N),
                          tc.block_diag_repeat(t(r_block), N), lo, -lo)
    scale = np.abs(np.asarray(ref.P)).max()
    np.testing.assert_allclose(out.P.numpy(), np.asarray(ref.P), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(out.q.numpy(), np.asarray(ref.q), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_array_equal(out.l.numpy(), np.asarray(ref.l))
    np.testing.assert_array_equal(out.u.numpy(), np.asarray(ref.u))


def _box_batch(rng, batch, nx=20, dtype=np.float64):
    """SPD Hessians built like tests/test_pallas.py:74-84."""
    mm = 0.3 * rng.normal(size=(batch, nx, nx))
    p = np.einsum("bij,bkj->bik", mm, mm) + 0.5 * np.eye(nx)
    q = rng.normal(size=(batch, nx))
    lo = np.full((batch, nx), -1.5)
    hi = np.full((batch, nx), 1.5)
    x0 = 0.1 * rng.normal(size=(batch, nx))
    return tuple(v.astype(dtype) for v in (p, q, lo, hi, x0))


@pytest.mark.parametrize("block", [1, 8])
def test_solve_box_qp_matches_jax_vmap(block):
    # 60 contracting ADMM iterations after an exact f64 inverse
    p, q, lo, hi, x0 = _box_batch(np.random.default_rng(2), 6)
    jcfg = jqp.ADMMConfig(iters=60, rho=0.1, kkt_block=block)
    ref = jax.vmap(lambda *a: jqp.solve_box_qp(*a[:4], jcfg, x0=a[4]))(
        *(jnp.asarray(v) for v in (p, q, lo, hi, x0)))
    tcfg = tqp.ADMMConfig(iters=60, rho=0.1, kkt_block=block)
    out = tqp.solve_box_qp(*(torch.tensor(v) for v in (p, q, lo, hi)), tcfg,
                           x0=torch.tensor(x0))
    for name in ("x", "z", "y", "primal_res", "dual_res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("nx,batch", [
    pytest.param(nx, batch, id=str(batch) if nx == 20 else f"nx{nx}-{batch}")
    for nx in (5, 20, 33) for batch in (7, 16)])
def test_box_admm_reference_matches_pallas_interpret(nx, batch):
    """float32, the Pallas kernel in interpret mode on identical inputs;
    atol 2e-6 as tests/test_pallas.py:87-101 (f32 matvec reassociation).
    batch=7 is the ragged case the TPU wrapper pads. nx = 20 is the main
    path's width; 5 and 33 are widths at which chip_smoke.py holds the
    CUDA kernel (its register and shared-memory instances) against this
    plain version. The kernel runs its fori_loop form (equal to the
    unrolled one at 1e-7, test_pallas.py:104), which interprets much
    faster."""
    p, q, lo, hi, x0 = _box_batch(np.random.default_rng(3), batch, nx,
                                  dtype=np.float32)
    cfg = jqp.ADMMConfig(iters=60, rho=0.1)
    ref = jqp.solve_box_qp_batch_pallas(
        *(jnp.asarray(v) for v in (p, q, lo, hi)), cfg, jnp.asarray(x0),
        unroll=False, interpret=True)
    t = torch.tensor
    rho = tqp._effective_rho(t(p), tqp.ADMMConfig(iters=60, rho=0.1))
    minv = tqp.spd_inverse(tqp.box_kkt(t(p), tqp.ADMMConfig(rho=0.1)))
    out = box_admm_reference(minv, t(q), t(lo), t(hi), t(x0),
                             torch.zeros_like(t(q)), rho, iters=60)
    np.testing.assert_allclose(out.z.numpy(), np.asarray(ref.x), atol=2e-6)
    np.testing.assert_allclose(out.y.numpy(), np.asarray(ref.y), atol=2e-6)
    primal = (out.xt - torch.clamp(out.xt, t(lo), t(hi))).abs().amax(-1)
    np.testing.assert_allclose(primal.numpy(), np.asarray(ref.primal_res),
                               atol=2e-6)


def test_box_admm_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    p, q, lo, hi, x0 = (torch.tensor(v) for v in
                        _box_batch(np.random.default_rng(4), 3))
    rho = torch.full((3,), 0.2, dtype=torch.float64)
    minv = tqp.spd_inverse(p + 0.2 * torch.eye(20, dtype=torch.float64))
    before = box_admm.launches
    a = box_admm(minv, q, lo, hi, x0, torch.zeros_like(q), rho, iters=30)
    b = box_admm_reference(minv, q, lo, hi, x0, torch.zeros_like(q), rho,
                           iters=30)
    assert box_admm.launches == before
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_kernel_route_on_cpu_equals_plain_route():
    p, q, lo, hi, x0 = (torch.tensor(v) for v in
                        _box_batch(np.random.default_rng(5), 4))
    cfg = tqp.ADMMConfig(iters=40, rho=0.1, kkt_block=8)
    a = tqp.make_box_qp_solver(cfg, "pallas")(p, q, lo, hi, x0, None)
    b = tqp.make_box_qp_solver(cfg, "xla")(p, q, lo, hi, x0, None)
    for name in ("x", "y", "primal_res", "dual_res"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy())


def test_box_admm_refuses_malformed_inputs():
    """The checks the wrapper runs before it hands pointers to the kernel."""
    from koopmanx_torch.ops.box_admm import _check

    minv = torch.eye(4).expand(3, 4, 4).contiguous()
    vec = torch.zeros(3, 4)
    good = {"q": vec, "lo": vec, "hi": vec, "x0": vec, "y0": vec}
    rho = torch.ones(3)
    _check(minv, good, rho, 10)
    cases = [
        (minv.to(torch.float16), good, rho, 10, TypeError),
        (minv[:, :, :3], good, rho, 10, ValueError),
        (minv, good, torch.ones(2), 10, ValueError),
        (minv, {**good, "q": torch.zeros(3, 5)}, rho, 10, ValueError),
        (minv, {**good, "lo": vec.double()}, rho, 10, TypeError),
        (minv, {**good, "hi": torch.zeros(4, 3).T}, rho, 10, ValueError),
        (minv, good, rho, -1, ValueError),
        (torch.eye(130).expand(3, 130, 130).contiguous(), good, rho, 10,
         ValueError),
    ]
    for m, vecs, r, iters, err in cases:
        with pytest.raises(err):
            _check(m, vecs, r, iters)


def test_launch_shape_refuses_other_dtypes():
    """The occupancy query takes the kernel's two types, and checks that
    before it loads the library."""
    with pytest.raises(TypeError):
        launch_shape(torch.float16, 8192, 20)
