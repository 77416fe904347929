"""The condensed QP-build kernel of koopmanx_torch (``ops/qp_build.py``,
``csrc/qp_build.cu``): the plain version against the engine's own
composition, the route the engine takes, the wrapper's refusals and the
counters, and, on a machine with a card, the kernel against its plain
version.

The plain version is the engine's composition (``weight_bar``,
``prediction_matrices(..., 'dag')``, the f_clamp, ``condensed_qp``); on
the CPU the kernel route runs it, so the CPU tests compare the routes bit
for bit on the inputs the engine's own control solve sees. This file
imports no JAX, so that its card tests run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qp_build.py

Presets: ``duffing`` (the flagship: nz 8, py 2, N 10), ``revise2_duffing``
(a per-scenario terminal block C P C'), ``tank`` (the du form: nz + m,
py 1, N 20) and ``vanderpol`` (lifted tracking: CyC = I, py = nz)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.control import condensed  # noqa: E402
from koopmanx_torch.engine import core, loop  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.ops import qp_build as qb  # noqa: E402
from koopmanx_torch.run import build_pipeline, run_scenarios  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.types import LinearModel  # noqa: E402
from koopmanx_torch.utils import profiling  # noqa: E402

F32, F64 = torch.float32, torch.float64
B = 4
PRESETS = ("duffing", "revise2_duffing", "tank", "vanderpol")
# the float32 card test's bound, of each scenario's largest |entry|, where
# the plain version's one-ulp change is below it
FLOAT32_RTOL = 1e-5


def run_preset(name, backend, device="cpu", batch=B, steps=1):
    """``steps`` steps of ``batch`` scenarios of the preset on
    ``backend``; returns the pipeline."""
    cfg = C.PRESETS[name]()
    cfg.steps = steps
    cfg.mpc.qp_backend = backend
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          param_scale=0.15, dtype=F32, device=device)
    run_scenarios(pipe, sc)
    return pipe


@pytest.fixture(scope="module")
def solves():
    """{preset: (make_control_solver's arguments, the first control
    solve's arguments)} of a one-step run of each preset (CPU, 'xla')."""
    out = {}
    real = loop.make_control_solver
    for name in PRESETS:
        seen = {}

        def factory(cfg, ref_fn, m, dictionary=None):
            seen["make"] = (cfg, ref_fn, m, dictionary)
            solve = real(cfg, ref_fn, m, dictionary)

            def recorded(*args):
                seen.setdefault("call", args)
                return solve(*args)
            return recorded

        loop.make_control_solver = factory
        try:
            run_preset(name, "xla")
        finally:
            loop.make_control_solver = real
        out[name] = (seen["make"], seen["call"])
    return out


def with_faults(model):
    """Scenario 1 gets a NaN in A, scenario 2 an inf, scenario 3 a -inf
    in B; scenario 0 stays as it was."""
    a, b = model.A.clone(), model.B.clone()
    a[1, 0, 1] = float("nan")
    a[2, 1, 0] = float("inf")
    b[3, 0, 0] = -float("inf")
    return model._replace(A=a, B=b)


def build_by(cfg, make, call, monkeypatch):
    """(P, q) of one control solve under ``cfg``: on the plain route what
    ``condensed_qp`` returns, on the kernel route what the wrapper
    returns; and whether the wrapper was called."""
    got, used = {}, []
    real_condensed, real_kernel = core.condensed_qp, qb.qp_build

    def condensed_spy(*args, **kwargs):
        qp = real_condensed(*args, **kwargs)
        got["qp"] = (qp.P, qp.q)
        return qp

    def kernel_spy(*args, **kwargs):
        used.append(True)
        out = real_kernel(*args, **kwargs)
        got["qp"] = out
        return out

    monkeypatch.setattr(core, "condensed_qp", condensed_spy)
    monkeypatch.setattr(qb, "qp_build", kernel_spy)
    _, ref_fn, m, dictionary = make
    with torch.inference_mode():  # as the loop runs it
        core.make_control_solver(cfg, ref_fn, m, dictionary)(*call)
    return got["qp"], bool(used)


# ---- the plain version (CPU) ----

@pytest.mark.parametrize("f_clamp", [1e5, 0.0], ids=["clamp", "no_clamp"])
@pytest.mark.parametrize("faults", [False, True], ids=["models", "faults"])
@pytest.mark.parametrize("name", PRESETS)
def test_plain_version_is_the_composition(solves, monkeypatch, name, faults,
                                          f_clamp):
    """The control solve's QP on the kernel route (on the CPU: the
    wrapper's plain version) equals the plain route's composition bit
    for bit, on each preset's first control solve, with a NaN, an inf and
    a -inf planted in the model and with the f_clamp on and off; with the
    clamp off the faults reach P and q, with it on they do not."""
    make, call = solves[name]
    call = list(call)
    if faults:
        call[1] = with_faults(call[1])
    cfg = dataclasses.replace(make[0], f_clamp=f_clamp)
    ref, used = build_by(dataclasses.replace(cfg, qp_backend="xla"), make,
                         call, monkeypatch)
    assert not used
    got, used = build_by(dataclasses.replace(cfg, qp_backend="pallas"),
                         make, call, monkeypatch)
    assert used
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        finite = torch.isfinite(r.reshape(B, -1)).all(-1)
        assert finite[0]
        assert finite[1:].all() == (not faults or f_clamp > 0)


def test_plain_version_is_the_dag_build():
    """The plain version is the 'dag' build: on a random model it equals
    the composition with ``prediction_matrices(..., 'dag')`` and differs
    in float32 from the 'scan' build's somewhere, so the route's 'dag'
    gate matters."""
    a, b, c, z, yr, q, r, term = random_case(16, 8, 1, 2, 10, seed=3,
                                             dtype=F32)
    p_kern, q_kern = qb.plain(a, b, c, z, yr, q, r, term, 10, 1e5)
    for method in ("dag", "scan"):
        pred = condensed.prediction_matrices(LinearModel(a, b, c), 10, None,
                                             method)
        qp = condensed.condensed_qp(
            pred, z, yr.flatten(-2), condensed.weight_bar(q, 10, term),
            condensed.block_diag_repeat(r, 10), z.new_zeros(()),
            z.new_zeros(()))
        same = torch.equal(qp.P, p_kern) and torch.equal(qp.q, q_kern)
        assert same == (method == "dag")


# ---- the route ----

def _route_case(**changes):
    cfg = core.EngineConfig(qp_backend="pallas")
    params = core.MPCParams(q_block=torch.eye(2), r_block=torch.eye(1),
                            u_min=-torch.ones(1), u_max=torch.ones(1))
    shape = dict(nz=8, m=1, py=2)
    for key, value in changes.items():
        if key in shape:
            shape[key] = value
        elif key in ("applied_min", "applied_max", "x_min", "x_max"):
            params = params._replace(**{key: value})
        else:
            cfg = dataclasses.replace(cfg, **{key: value})
    return cfg, params, shape


ROUTES = {  # changes from the flagship on 'pallas' -> takes the kernel
    "kernel": ({}, True),
    "xla": ({"qp_backend": "xla"}, False),
    "scan": ({"markov": "scan"}, False),
    "doubling": ({"markov": "doubling"}, False),
    "state_bounds": ({"state_bounds": True, "x_min": -torch.ones(20),
                      "x_max": torch.ones(20)}, False),
    "state_bounds_unset": ({"state_bounds": True}, True),
    "applied_rows": ({"delta_u": True, "applied_bounds": "rows",
                      "applied_min": -torch.ones(1),
                      "applied_max": torch.ones(1)}, False),
    "applied_box": ({"delta_u": True, "applied_bounds": "box",
                     "applied_min": -torch.ones(1),
                     "applied_max": torch.ones(1)}, True),
    "rbf128": ({"nz": 128}, False),
    "nz32": ({"nz": 32}, True),
    "nz33": ({"nz": 33}, False),
    "nx32": ({"horizon": 16, "m": 2}, True),
    "nx33": ({"horizon": 33}, False),
    "tank_mimo": ({"horizon": 20, "m": 2, "py": 1}, False),
    "np128": ({"horizon": 4, "py": 32}, True),
    "py33": ({"horizon": 1, "py": 33}, False),
    "np130": ({"horizon": 10, "py": 13}, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_choice(case):
    """The engine takes the kernel on ``qp_backend='pallas'``'s box path
    with the 'dag' build and a shape ``supported`` takes (nz <= 32,
    N m <= 32, py <= 32, N py <= 128); the 'xla' route, the other Markov
    builds, the applied-window and state-box rows and wider shapes
    (rbf128's nz = 128, tank_mimo's N m = 40) go plain."""
    changes, expect = ROUTES[case]
    cfg, params, shape = _route_case(**changes)
    assert core._takes_build_kernel(cfg, params, **shape) == expect
    if case in ("kernel", "rbf128", "nz32", "nz33", "nx32", "nx33",
                "tank_mimo", "np128", "py33", "np130"):
        assert qb.supported(shape["nz"], shape["m"], shape["py"],
                            cfg.horizon) == expect


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_engine_sets_the_route_and_counts_rows(backend, monkeypatch):
    """Two steps of the flagship ask for the wrapper once a step on
    ``qp_backend='pallas'`` and never on ``'xla'``; with the spans on,
    ``qp_build.rows`` counts every built scenario and
    ``qp_build.kernel_rows`` those of the kernel route."""
    calls = []
    real = qb.qp_build
    monkeypatch.setattr(qb, "qp_build",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    profiling.enable(True)
    try:
        run_preset("duffing", backend, batch=3, steps=2)
        counted = profiling.counters()
    finally:
        profiling.enable(False)
    on_kernel = backend == "pallas"
    assert len(calls) == (2 if on_kernel else 0)
    assert counted["qp_build.rows"] == 6
    assert counted.get("qp_build.kernel_rows", 0) == (6 if on_kernel else 0)


def test_counters_are_off_without_the_spans():
    """With the spans off the build counts nothing."""
    profiling.enable(False)
    run_preset("duffing", "pallas", batch=2, steps=1)
    assert "qp_build.rows" not in profiling.counters()


# ---- the wrapper ----

def random_case(batch, nz, m, py, horizon, seed, dtype=F64, device="cpu",
                terminal=True, shared=True):
    """Random (A, B, CyC, z, yr, Q, R, terminal): A of spectral radius
    0.6-1.2, Q and R symmetric positive definite, shared by the batch
    where ``shared`` (else per scenario, as is yr), a per-scenario
    terminal block where ``terminal``."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, nz, nz))
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    a *= rng.uniform(0.6, 1.2, size=(batch, 1, 1)) / radius[:, None, None]

    def spd(lead, k, scale):
        x = rng.normal(size=lead + (k, k))
        return scale * (x @ np.swapaxes(x, -1, -2) / k + np.eye(k))

    lead = () if shared else (batch,)
    arrays = [a, rng.normal(size=(batch, nz, m)),
              rng.normal(size=(batch, py, nz)), rng.normal(size=(batch, nz)),
              rng.normal(size=lead + (horizon, py)), spd(lead, py, 10.0),
              spd(lead, m, 0.1)]
    arrays.append(spd((batch,), py, 30.0) if terminal else None)
    return tuple(None if v is None
                 else torch.tensor(v, dtype=dtype, device=device)
                 for v in arrays)


def _args():
    return list(random_case(3, 5, 2, 2, 4, seed=1))


def _set(i, fn):
    def make(args):
        args = list(args)
        args[i] = fn(args[i])
        return args
    return make


REFUSALS = {
    "float16": (lambda args: [t.half() for t in args], TypeError),
    "int": (lambda args: [t.long() for t in args], TypeError),
    "mixed_dtype": (_set(5, lambda t: t.float()), TypeError),
    "device": (_set(5, lambda t: t.to("meta")), ValueError),
    "a_not_square": (_set(0, lambda t: t[:, :4]), ValueError),
    "b_rows": (_set(1, lambda t: t[:, :4]), ValueError),
    "cy_c_shared": (_set(2, lambda t: t[0]), ValueError),
    "cy_c_columns": (_set(2, lambda t: t[..., :4]), ValueError),
    "z_shape": (_set(3, lambda t: t[:2]), ValueError),
    "yr_shape": (_set(4, lambda t: t[:3]), ValueError),
    "q_shape": (_set(5, lambda t: t[:1, :1]), ValueError),
    "r_shape": (_set(6, lambda t: t[:1, :1]), ValueError),
    "terminal_shape": (_set(7, lambda t: t[:2]), ValueError),
    "nz33": (lambda args: list(random_case(2, 33, 1, 2, 4, seed=2)),
             ValueError),
    "nx33": (lambda args: list(random_case(2, 4, 3, 1, 11, seed=2)),
             ValueError, 11),
    "np132": (lambda args: list(random_case(2, 4, 1, 12, 11, seed=2)),
              ValueError, 11),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    """A dtype other than float32 / float64, two dtypes or devices, a
    wrong shape of any input, or a shape ``supported`` refuses raise
    before any work, each for its own fault."""
    make, exc, *horizon = REFUSALS[case]
    with pytest.raises(exc):
        qb.qp_build(*make(_args()), *(horizon or [4]), 1e5)


def test_wrapper_reads_any_layout_and_runs_plain_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version, launches
    nothing, and gives the same (P, q) for transposed, expanded and
    sliced views of its inputs as for contiguous copies."""
    args = _args()
    before = qb.qp_build.launches
    ref = qb.qp_build(*args, 4, 0.0)
    a, b, c, z, yr, q, r, term = args
    views = [a.transpose(1, 2).contiguous().transpose(1, 2),
             torch.cat([b, b], -1)[..., :2], c.clone(),
             torch.cat([z, z], -1)[:, :5], yr.expand((3,) + yr.shape),
             q.expand((3,) + q.shape), r, term]
    got = qb.qp_build(*views, 4, 0.0)
    assert qb.qp_build.launches == before
    for g, rr in zip(got, ref):
        torch.testing.assert_close(g, rr, rtol=0, atol=0)
    assert ref[0].shape == (3, 8, 8) and ref[1].shape == (3, 8)


def test_wrapper_refuses_autograd():
    """Under autograd the wrapper raises (the kernel has no gradient)
    before anything else; under ``no_grad`` it runs the plain version."""
    args = _args()
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        qb.qp_build(*args, 4, 1e5)
    with torch.no_grad():
        p, _ = qb.qp_build(*args, 4, 1e5)
    assert p.shape == (3, 8, 8)


# ---- the kernel on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, ref):
    """Each scenario's largest |difference| over its reference's largest
    |entry|."""
    axes = tuple(range(1, ref.dim()))
    return ((got - ref).abs().amax(dim=axes)
            / ref.abs().amax(dim=axes).clamp_min(1e-300))


# (nz, m, py, N, batch): the caps' edges and a lone scenario
EDGES = [(32, 1, 2, 10, 33), (8, 1, 2, 32, 7), (8, 2, 4, 16, 5),
         (4, 4, 32, 4, 3), (1, 1, 1, 1, 9), (5, 3, 3, 7, 40)]
PRESET_SHAPES = {"duffing": (8, 1, 2, 10), "revise2_duffing": (10, 1, 2, 10),
                 "tank": (11, 1, 1, 20), "vanderpol": (8, 1, 8, 10)}


def _cases(device, dtype):
    """(id, args, horizon): the edges, half with a shared Q, R and yr and
    a terminal block, half per scenario and without; and each preset's
    shape with a terminal block."""
    out = []
    for i, (nz, m, py, n, batch) in enumerate(EDGES):
        args = random_case(batch, nz, m, py, n, seed=i, dtype=dtype,
                           device=device, terminal=i % 2 == 0,
                           shared=i % 2 == 0)
        out.append((f"edge{nz}_{m}_{py}_{n}", args, n))
    for name, (nz, m, py, n) in PRESET_SHAPES.items():
        out.append((name, random_case(65, nz, m, py, n, seed=nz + n,
                                      dtype=dtype, device=device), n))
    return out


@pytest.mark.parametrize("f_clamp", [1e5, 0.0], ids=["clamp", "no_clamp"])
def test_kernel_matches_plain_float64(card, f_clamp):
    """float64: P and q within 1e-12 of each scenario's largest |entry|,
    at the edges of ``supported`` (nz 32, N m 32, py 32 with N py 128,
    one state and one step) and at each preset's shape, with Q, R and yr
    shared or per scenario and with and without a terminal block; one
    launch a call."""
    for name, args, n in _cases(card, F64):
        before = qb.qp_build.launches
        got = qb.qp_build(*args, n, f_clamp)
        assert qb.qp_build.launches == before + 1
        ref = qb.plain(*args, n, f_clamp)
        for g, r in zip(got, ref):
            assert torch.isfinite(r).all()
            assert (rel_err(g, r) <= 1e-12).all(), (name, rel_err(g, r).max())


def test_kernel_reads_any_layout(card):
    """Transposed, sliced and expanded views of the inputs (as the
    engine passes a solved model, a replicated Q and lifted tracking's
    expanded identity) give the contiguous copies' P and q bit for
    bit."""
    args = random_case(33, 8, 1, 8, 10, seed=4, device=card)
    a, b, c, z, yr, q, r, term = args
    eye = torch.eye(8, dtype=F64, device=card)
    views = [a.transpose(1, 2).contiguous().transpose(1, 2),
             torch.cat([b, b], -1)[..., :1], eye.expand(33, 8, 8),
             torch.cat([z, z], -1)[:, 3:11], yr.expand((33,) + yr.shape),
             q.expand((33,) + q.shape), r.expand((33,) + r.shape), term]
    copies = [v.contiguous() for v in views]
    for got, ref in zip(qb.qp_build(*views, 10, 1e5),
                        qb.qp_build(*copies, 10, 1e5)):
        assert torch.equal(got, ref)


def test_kernel_float32_within_plain_round_off(card):
    """float32 against the plain version in float32 on the card: each
    scenario's P and q within FLOAT32_RTOL of its largest |entry| or
    within ten times the plain version's own change when A moves by one
    float32 ulp (up, then down), where that is larger."""
    for name, args, n in _cases(card, F32):
        a = args[0]
        got, ref = qb.qp_build(*args, n, 1e5), qb.plain(*args, n, 1e5)
        nudged = [qb.plain(torch.nextafter(a, torch.full_like(a, t)),
                           *args[1:], n, 1e5)
                  for t in (float("inf"), -float("inf"))]
        for i, (g, r) in enumerate(zip(got, ref)):
            axes = tuple(range(1, r.dim()))
            amax = lambda t: t.abs().amax(dim=axes)  # noqa: E731
            floor = torch.stack([amax(v[i].double() - r.double())
                                 for v in nudged]).amax(0)
            bound = torch.maximum(FLOAT32_RTOL * amax(r.double()),
                                  10.0 * floor)
            diff = amax(g.double() - r.double())
            assert (diff <= bound).all(), (name, i, (diff / bound).max())


def nonfinite_case(device, dtype, n=10):
    """The flagship's shape with a per-scenario Q, yr and terminal block
    and a fault in each scenario but the first: a NaN, an inf and a -inf
    in A, a NaN in B, an inf in CyC, in z and in yr, a NaN in Q (Qbar's
    off-block zeros), in R (Rbar's) and in the terminal block."""
    a, b, c, z, yr, q, r, term = random_case(11, 8, 1, 2, n, seed=5,
                                             dtype=dtype, device=device,
                                             shared=False)
    a[1, 0, 1] = float("nan")
    a[2, 3, 3] = float("inf")
    a[3, 7, 0] = -float("inf")
    b[4, 2, 0] = float("nan")
    c[5, 1, 4] = float("inf")
    z[6, 6] = float("inf")
    yr[7, 4, 1] = float("nan")
    q[8, 0, 1] = float("nan")
    r[9, 0, 0] = float("nan")
    term[10, 1, 1] = float("inf")
    return a, b, c, z, yr, q, r, term


@pytest.mark.parametrize("f_clamp", [1e5, 0.0], ids=["clamp", "no_clamp"])
def test_nonfinite_propagates(card, f_clamp):
    """With a fault in every input, P and q are non-finite in the same
    entries as the plain version's, in float64 and float32, the clamped
    build too (where Q, R, z, yr and the terminal block still reach P
    and q); the unfaulted scenario stays finite."""
    for dtype in (F64, F32):
        args = nonfinite_case(card, dtype)
        got, ref = qb.qp_build(*args, 10, f_clamp), qb.plain(*args, 10,
                                                              f_clamp)
        bad = torch.zeros(11, dtype=torch.bool, device=card)
        for g, r in zip(got, ref):
            assert torch.equal(torch.isfinite(g), torch.isfinite(r))
            bad |= ~torch.isfinite(r.reshape(11, -1)).all(-1)
        assert not bad[0] and bad[6:].all()
        assert bad[1:6].all() == (f_clamp == 0.0)


def test_engine_launches_the_kernel_once_a_step(card):
    """The flagship on the card: three steps launch the kernel three
    times on ``qp_backend='pallas'`` and never on ``'xla'``."""
    before = qb.qp_build.launches
    run_preset("duffing", "pallas", device=card, batch=8, steps=3)
    assert qb.qp_build.launches == before + 3
    run_preset("duffing", "xla", device=card, batch=8, steps=3)
    assert qb.qp_build.launches == before + 3


def test_launch_opens_its_record(card):
    """The kernel runs under the always-on record ``kx.qp_build_kernel``
    (spans off), so a profiler counts its device time under whatever
    range was open at the launch."""
    from torch.profiler import ProfilerActivity, profile

    args = random_case(64, 8, 1, 2, 10, seed=9, dtype=F32, device=card)
    qb.qp_build(*args, 10, 1e5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        qb.qp_build(*args, 10, 1e5)
        torch.cuda.synchronize()
    records = [e for e in prof.events() if e.name == "kx.qp_build_kernel"]
    assert len(records) == 1
    kernels = [k.name for e in records for k in e.kernels]
    assert (any("qp_build_kernel" in k for k in kernels)
            or records[0].device_time_total > 0)
