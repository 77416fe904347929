"""koopmanx_torch's fused condensed-QP path and its general ADMM solve_qp
against the JAX package: the plain version against both Pallas kernels in
interpret mode, the fused solve at convergence against solve_qp,
solve_qp against JAX's, and the wrappers' CPU dispatch and input checks.
float64 unless stated; inputs made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.control import qp as jqp  # noqa: E402
from koopmanx.ops.qp_pallas import FusedQPConfig as JFusedQPConfig  # noqa: E402
from koopmanx.ops.qp_pallas import fused_qp_solve as j_fused_aos  # noqa: E402
from koopmanx.ops.qp_pallas_soa import fused_qp_solve_soa as j_fused_soa  # noqa: E402
from koopmanx.types import QPData as JQPData  # noqa: E402

from koopmanx_torch.control import condensed as tc  # noqa: E402
from koopmanx_torch.control import qp as tqp  # noqa: E402
from koopmanx_torch.ops import FusedQPConfig, fused_qp_solve, fused_qp_solve_soa  # noqa: E402
from koopmanx_torch.ops.fused_qp import (  # noqa: E402
    aos_instance,
    aos_launch_shape,
    aos_shared_bytes,
    check_aos_limits,
    check_inputs,
    check_soa_limits,
    fused_qp_reference,
    soa_instance,
    soa_scratch_rows,
    soa_shared_bytes,
)
from koopmanx_torch.ops.fused_qp_soa import launch_shape as soa_launch_shape  # noqa: E402
from koopmanx_torch.types import LinearModel, QPData  # noqa: E402

NZ, N = 8, 10  # the tests/test_pallas.py fixture: B=8, nz=8, m=1, py=2, N=10


def _fused_inputs(seed, batch=8, m=1, py=2, horizon=N):
    """Models built like tests/test_pallas.py:18-43, a warm start off zero."""
    rng = np.random.default_rng(seed)
    a = 0.1 * rng.normal(size=(batch, NZ, NZ)) + 0.8 * np.eye(NZ)
    b = 0.3 * rng.normal(size=(batch, NZ, m))
    cyc = 0.5 * rng.normal(size=(batch, py, NZ))
    z0 = rng.normal(size=(batch, NZ))
    yr = np.tile([1.0] + [0.0] * (py - 1), (batch, horizon))
    warm = 0.1 * rng.normal(size=(batch, horizon * m))
    return a, b, cyc, z0, yr, warm


def _cfg_kw(m=1, schulz=16, iters=60, horizon=N, tile=8):
    return dict(horizon=horizon, iters=iters, rho=0.1, schulz_iters=schulz,
                tile=tile, rdiag=(1e-4,) * m, u_lo=(-2.0,) * m, u_hi=(2.0,) * m)


@pytest.mark.parametrize("m,schulz,batch,layout", [
    pytest.param(m, schulz, 8, layout, id=f"{m}-{schulz}-{layout}")
    for m, schulz in [(1, 16), (1, 24), (2, 16)] for layout in ("aos", "soa")
] + [pytest.param(1, 16, 37, "soa", id="1-16-B37-soa")])
def test_fused_reference_matches_pallas_interpret(m, schulz, batch, layout):
    """The plain version against each TPU kernel, same f64 inputs, to
    1e-9. Same arithmetic; the sums run in another order, and for the AoS
    kernel with m = 2 (py = 2) F2' comes from its dual Markov recursion
    where the port reads F2 transposed (the SoA kernel always recurses):
    rounding differences of ~1e-16 relative, which the unconverged
    Newton-Schulz inverse (schulz_iters 16) carries through with their
    relative size and 60 contracting ADMM iterations do not amplify
    (measured ~1e-12). B = 37, no multiple of the CUDA kernel's 32 (or
    16) scenarios a block, runs as one TPU tile of 37 lanes."""
    inputs = _fused_inputs(10 * m + schulz, batch=batch, m=m)
    kw = _cfg_kw(m=m, schulz=schulz, tile=8 if batch % 8 == 0 else batch)
    jfn = j_fused_aos if layout == "aos" else j_fused_soa
    ref = jfn(*(jnp.asarray(v) for v in inputs), JFusedQPConfig(**kw),
              interpret=True)
    out = fused_qp_reference(*(torch.tensor(v) for v in inputs),
                             FusedQPConfig(**kw))
    assert out.shape == (batch, N * m)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


def _condensed_as_general_qp(inputs, dtype=torch.float64):
    """The fixture's condensed QP, as tests/test_pallas.py:28-42 builds it,
    in OSQP form with identity rows."""
    a, b, cyc, z0, yr, _ = (torch.tensor(v, dtype=dtype) for v in inputs)
    batch = a.shape[0]
    pred = tc.prediction_matrices(LinearModel(a, b, cyc), N)
    qbar = tc.weight_bar(100.0 * torch.eye(2, dtype=dtype).expand(batch, 2, 2), N)
    rbar = 1e-4 * torch.eye(N, dtype=dtype).expand(batch, N, N)
    lo = torch.full((batch, N), -2.0, dtype=dtype)
    box = tc.condensed_qp(pred, z0, yr, qbar, rbar, lo, -lo)
    eye = torch.eye(N, dtype=dtype).expand(batch, N, N)
    return QPData(box.P, box.q, eye, box.l, box.u)


@pytest.mark.parametrize("entry", [fused_qp_solve, fused_qp_solve_soa])
def test_fused_solve_converges_to_solve_qp(entry):
    """At 800 iterations and 24 Newton-Schulz steps the fused solve (the
    plain version, CPU tensors) reaches the general solver's solution
    within 5e-3, as tests/test_pallas.py:46-61 holds the TPU kernels: the
    two ADMMs take different valid iterate sequences."""
    inputs = _fused_inputs(0)
    kw = _cfg_kw(schulz=24, iters=800)
    u = entry(*(torch.tensor(v) for v in inputs), FusedQPConfig(**kw))
    sol = tqp.solve_qp_batch(_condensed_as_general_qp(inputs),
                             tqp.ADMMConfig(iters=800, rho=0.1))
    np.testing.assert_allclose(u.numpy(), sol.x.numpy(), rtol=0, atol=5e-3)


def _general_qps(rng, batch, nx=6, nc=10):
    """SPD P, and A = [I; random rows] so that l <= Ax <= u has inequality
    rows beyond the box."""
    mm = rng.normal(size=(batch, nx, nx))
    p = np.einsum("bij,bkj->bik", mm, mm) + 0.5 * np.eye(nx)
    q = rng.normal(size=(batch, nx))
    extra = rng.normal(size=(batch, nc - nx, nx))
    a = np.concatenate([np.broadcast_to(np.eye(nx), (batch, nx, nx)), extra], 1)
    lo = -1.0 - rng.uniform(size=(batch, nc))
    hi = 1.0 + rng.uniform(size=(batch, nc))
    x0 = 0.1 * rng.normal(size=(batch, nx))
    y0 = 0.1 * rng.normal(size=(batch, nc))
    return (p, q, a, lo, hi), x0, y0


@pytest.mark.parametrize("block,scale_rho", [(1, True), (4, False)])
def test_solve_qp_batch_matches_jax_vmap(block, scale_rho):
    """float64, warm x0/y0, 4 inequality rows beyond the identity; 1e-10
    for the KKT inverse's and the matvecs' summation order."""
    data, x0, y0 = _general_qps(np.random.default_rng(block), 5)
    jcfg = jqp.ADMMConfig(iters=80, rho=0.1, kkt_block=block,
                          scale_rho=scale_rho)
    ref = jqp.solve_qp_batch(JQPData(*(jnp.asarray(v) for v in data)), jcfg,
                             jnp.asarray(x0), jnp.asarray(y0))
    tcfg = tqp.ADMMConfig(iters=80, rho=0.1, kkt_block=block,
                          scale_rho=scale_rho)
    out = tqp.solve_qp_batch(QPData(*(torch.tensor(v) for v in data)), tcfg,
                             torch.tensor(x0), torch.tensor(y0))
    for name in ("x", "z", "y", "primal_res", "dual_res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-10)
    assert out.iterations == 80


def test_solve_qp_unbatched_matches_jax():
    """One QP with no batch axis, cold start: the JAX function itself."""
    data, _, _ = _general_qps(np.random.default_rng(7), 1)
    data = tuple(v[0] for v in data)
    cfg = dict(iters=50, rho=0.1)
    ref = jqp.solve_qp(JQPData(*(jnp.asarray(v) for v in data)),
                       jqp.ADMMConfig(**cfg))
    out = tqp.solve_qp(QPData(*(torch.tensor(v) for v in data)),
                       tqp.ADMMConfig(**cfg))
    assert out.x.shape == (6,) and out.primal_res.shape == ()
    for name in ("x", "z", "y", "primal_res", "dual_res"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("entry", [fused_qp_solve, fused_qp_solve_soa])
def test_fused_entry_on_cpu_is_the_plain_version(entry):
    """A CPU tensor takes the plain version bit for bit and launches
    nothing; a ragged B = 7 (no tile multiple) is accepted, float32."""
    inputs = [torch.tensor(v, dtype=torch.float32)
              for v in _fused_inputs(3, batch=7)]
    cfg = FusedQPConfig(**_cfg_kw())
    before = entry.launches
    out = entry(*inputs, cfg)
    assert entry.launches == before
    assert out.shape == (7, N) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  fused_qp_reference(*inputs, cfg).numpy())


def test_fused_reference_isolates_poisoned_scenarios():
    """A non-finite model or state poisons its own scenario only, with the
    same NaN pattern as the AoS TPU kernel (interpret mode); its
    neighbours equal a run without the poisoned scenarios."""
    inputs = [np.array(v) for v in _fused_inputs(5)]
    clean = fused_qp_reference(*(torch.tensor(v) for v in inputs),
                               FusedQPConfig(**_cfg_kw()))
    inputs[0][1, 0, 0] = np.nan  # A
    inputs[3][3, 0] = np.inf  # z0
    inputs[1][4, 2, 0] = -np.inf  # B: the Markov clamp keeps it finite
    kw = _cfg_kw()
    ref = np.asarray(j_fused_aos(*(jnp.asarray(v) for v in inputs),
                                 JFusedQPConfig(**kw), interpret=True))
    out = fused_qp_reference(*(torch.tensor(v) for v in inputs),
                             FusedQPConfig(**kw)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out[[1, 3]]).all() and np.isfinite(out[4]).all()
    keep = [0, 2, 5, 6, 7]
    np.testing.assert_array_equal(out[keep], clean.numpy()[keep])
    np.testing.assert_allclose(out[4], ref[4], rtol=0, atol=1e-9)


def test_fused_config_matches_jax_defaults():
    assert FusedQPConfig._fields == JFusedQPConfig._fields
    assert tuple(FusedQPConfig()) == tuple(JFusedQPConfig())


def test_fused_wrappers_refuse_malformed_inputs():
    """The checks both wrappers run before they hand pointers to a
    kernel, and the AoS kernel's size limits."""
    good = [torch.tensor(v, dtype=torch.float32) for v in _fused_inputs(6)]
    cfg = FusedQPConfig(**_cfg_kw())
    assert check_inputs(*good, cfg) == (8, NZ, 1, 2)
    a, b, cyc, z0, yr, warm = good
    bad_inputs = [
        ([a.half(), b, cyc, z0, yr, warm], TypeError),
        ([a, b.double(), cyc, z0, yr, warm], TypeError),
        ([a[:, :, :7], b, cyc, z0, yr, warm], ValueError),
        ([a, b[0], cyc, z0, yr, warm], ValueError),
        ([a, b, cyc, z0[:4], yr, warm], ValueError),
        ([a, b, cyc, z0, yr[:, :-1], warm], ValueError),
        ([a, b, cyc, z0, yr, warm[:, :5]], ValueError),
        ([a, b, cyc, z0, yr, torch.zeros(N, 8).T], ValueError),
        ([a[:0], b[:0], cyc[:0], z0[:0], yr[:0], warm[:0]], ValueError),
    ]
    for args, err in bad_inputs:
        with pytest.raises(err):
            check_inputs(*args, cfg)
    for bad_cfg in (cfg._replace(horizon=0), cfg._replace(iters=-1),
                    cfg._replace(schulz_iters=-1), cfg._replace(qdiag=()),
                    cfg._replace(u_lo=(-1.0,) * 17)):
        with pytest.raises(ValueError):
            check_inputs(*good, bad_cfg)
    check_aos_limits(NZ, 1, 2, FusedQPConfig(), torch.float64)
    with pytest.raises(ValueError, match="N\\*m"):
        check_aos_limits(NZ, 2, 2, FusedQPConfig(horizon=65), torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        check_aos_limits(NZ, 1, 2, FusedQPConfig(horizon=100), torch.float64)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_qp_solve(*(t.to("meta") for t in good), cfg)
    # the SoA kernel: its global instance's per-channel vectors in 48 KB
    check_soa_limits(NZ, 1, 2, FusedQPConfig(), torch.float64)
    check_soa_limits(NZ, 2, 2, FusedQPConfig(horizon=1100), torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        check_soa_limits(NZ, 2, 2, FusedQPConfig(horizon=1100), torch.float64)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_qp_solve_soa(*(t.to("meta") for t in good), cfg)
    with pytest.raises(TypeError):
        soa_launch_shape(torch.float16, 8, NZ, 1, 2, cfg)
    with pytest.raises(TypeError):
        aos_launch_shape(torch.float16, 8, NZ, 1, 2, cfg)


def _soa_layout_bytes(nz, m, py, horizon, dtype):
    """``SmemLayout`` of ``csrc/fused_qp_soa.cu``, spelled out: X and T
    (NXP^2 each; the prologue's A, B, CyC, two CyC A^j, two A^j z0, the
    Markov blocks and the error in T's space where they fit), q, two rhs
    buffers, two norm partials per row group (NXP / 2 of them); S lanes
    each (32 in float32, 16 in float64); then Qbar."""
    nxp = -(-horizon * m // 4) * 4
    prologue = (nz * nz + nz * m + py * nz * 3 + nz * 2 + horizon * py * m
                + horizon * py)
    per_lane = 2 * nxp * nxp + max(0, prologue - nxp * nxp) + 3 * nxp + nxp
    lanes = 32 if dtype == torch.float32 else 16
    item = 4 if dtype == torch.float32 else 8
    return item * (per_lane * lanes + horizon * py)


@pytest.mark.parametrize("nz,m,horizon,dtype,instance,nbytes", [
    (8, 1, 20, torch.float32, "shared", 112_800),  # the flagship's shapes
    (8, 1, 20, torch.float64, "shared", 112_960),
    (8, 1, 10, torch.float64, "shared", None),  # the convergence gate's N
    (8, 1, 24, torch.float32, "shared", None),  # the widest float32 NXP
    (8, 1, 24, torch.float64, "global", None),  # past float64's NXP of 20
    (8, 2, 20, torch.float32, "global", None),  # N*m = 40
    (64, 1, 20, torch.float32, "global", None),  # prologue past 227 KB
])
def test_soa_instance_follows_the_kernel_layout(nz, m, horizon, dtype,
                                                instance, nbytes):
    """The SoA wrapper's choice of instance and its shared-memory sizes
    against the kernel's layout rules: the shared instance where N*m,
    rounded up to 4, is at most 24 (float32) or 20 (float64) and its block
    fits 227 KB; the global instance, with its (rows, B) scratch,
    elsewhere. The product order is the first design's, so no emulation
    of another order is needed."""
    cfg = FusedQPConfig(horizon=horizon)
    got = soa_shared_bytes(nz, m, 2, horizon, dtype)
    assert got == _soa_layout_bytes(nz, m, 2, horizon, dtype)
    if nbytes is not None:
        assert got == nbytes
    assert soa_instance(nz, m, 2, cfg, dtype) == instance
    nx = horizon * m
    assert soa_scratch_rows(nz, m, 2, horizon) == (
        2 * 2 * nz + 2 * nz + horizon * 2 * m + horizon * 2 + 5 * nx
        + 4 * nx * nx)


def _aos_layout_bytes(nz, m, py, horizon, dtype, instance):
    """One warp's slice of ``csrc/fused_qp.cu``, spelled out. The first
    design (``Layout``): A (nz^2), B (nz m), CyC and two CyC A^j buffers
    (py nz each), two A^j z0 buffers (nz each), the Markov blocks (N py m),
    the error and Qbar (N py each), q and rhs (N m each), K, X, T and the
    next X ((N m)^2 each). The register instance (``RegsLayout``, in
    16-byte units): K' (NXP^2, NXP = N*m rounded up to 4), then X, X' and
    T (3 NXP^2, or the prologue's arrays A ... error where they take more),
    padded to 16 bytes; two rhs buffers and q (NXP each), Qbar (N py); the
    whole padded to 16 bytes."""
    item = 4 if dtype == torch.float32 else 8
    nx, nrow = horizon * m, horizon * py
    prologue = (nz * nz + nz * m + py * nz * 3 + nz * 2 + nrow * m + nrow)
    if instance == "generic":
        return item * (prologue + nrow + nx + nx + 4 * nx * nx)
    nxp = -(-nx // 4) * 4
    pad = lambda nbytes: -(-nbytes // 16) * 16
    head = pad(item * nxp * nxp) + pad(item * max(3 * nxp * nxp, prologue))
    return pad(head + item * (2 * nxp + nxp + nrow))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("horizon,m,instance,regs_f32", [
    (10, 1, "regs", None),  # the convergence gate's N: NXP = 12, padded
    (20, 1, "regs", 6_800),  # the flagship's shapes, NXP = 20
    (24, 1, "regs", None),  # NXP = 24: two tiles on some lanes
    (8, 4, "regs", None),  # N*m = 32, the widest register instance
    (33, 1, "generic", None),  # past the register instance
    (20, 2, "generic", None),  # N*m = 40
], ids=["nx10", "nx20", "nx24", "nx32", "nx33", "nx40"])
def test_aos_instance_follows_the_kernel_layout(horizon, m, instance,
                                                regs_f32, dtype):
    """The AoS wrapper's choice of instance and its shared-memory sizes
    against the kernel's layout rules: the register instance for N*m <= 32
    (its slice fits 227 KB at every such shape here), the first design
    above; both layouts' sizes, and the first design's bounds the
    wrapper's limits. The register instance's product order is the first
    design's, so no emulation of another order is needed."""
    cfg = FusedQPConfig(horizon=horizon)
    for layout in ("generic", "regs"):
        assert aos_shared_bytes(NZ, m, 2, horizon, dtype, layout) == (
            _aos_layout_bytes(NZ, m, 2, horizon, dtype, layout))
    regs = aos_shared_bytes(NZ, m, 2, horizon, dtype, "regs")
    assert regs % 16 == 0
    if regs_f32 is not None:
        assert regs == regs_f32 * (1 if dtype == torch.float32 else 2)
    assert aos_instance(NZ, m, 2, cfg, dtype) == instance
    check_aos_limits(NZ, m, 2, cfg, dtype)  # every such shape is accepted
