"""The per-step terminal synthesis kernel of koopmanx_torch
(``ops/dare_terminal.py``, ``csrc/dare_terminal.cu``): the route
``synthesize_terminal`` takes, the wrapper's refusals, and, on a machine
with a card, the kernel against its plain version.

The plain version is ``synthesize_terminal``'s plain route, the
composition the JAX package's tests hold the port to
(``tests/test_torch_dare.py``); on the CPU the kernel route runs it too,
so the CPU tests compare the routes bit for bit. This file imports no
JAX, so that its card tests run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dare_terminal.py

Models: the batch EDMD models of the ``revise2_duffing`` (nz = 10) and
``revise2_vdp`` (nz = 8) presets, each scenario nudged by its own noise,
and random stabilizable pairs at other widths (A of spectral radius
0.6-1.2, Q = diag(10, 10, 0, ...) or 10 I, R = 0.01 I)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.control import dare  # noqa: E402
from koopmanx_torch.control import terminal  # noqa: E402
from koopmanx_torch.ops import dare_terminal as dt  # noqa: E402
from koopmanx_torch.run import build_pipeline  # noqa: E402
from koopmanx_torch.types import LinearModel  # noqa: E402
from koopmanx_torch.utils import profiling  # noqa: E402

F32, F64 = torch.float32, torch.float64
B = 6
PRESETS = ("revise2_duffing", "revise2_vdp")
# the float32 card test's bound, of each scenario's largest |entry|, where
# the model's one-ulp floor is below it
FLOAT32_RTOL = 1e-5


@pytest.fixture(scope="module")
def preset_models():
    """{preset: (A, B, Q_lift, R)} in float64: the preset's batch model in
    B scenarios, each but the first nudged by 1e-3 relative noise."""
    out = {}
    rng = np.random.default_rng(3)
    for name in PRESETS:
        cfg = C.PRESETS[name]()
        cfg.steps = 2
        pipe = build_pipeline(cfg, device="cpu")
        a0 = pipe.model0.A.to(F64)
        b0 = pipe.model0.B.to(F64)
        noise = torch.tensor(rng.normal(size=(B,) + tuple(a0.shape)))
        noise[0] = 0.0
        a = a0 * (1.0 + 1e-3 * noise)
        b = b0.expand((B,) + tuple(b0.shape)).contiguous()
        out[name] = (a, b, pipe.params.q_lift.to(F64),
                     pipe.params.r_block.to(F64))
    return out


def random_pairs(batch, nz, m, seed):
    """``batch`` random stabilizable (A, B) with Q and R, float64."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, nz, nz))
    radius = np.abs(np.linalg.eigvals(a)).max(-1)
    a *= rng.uniform(0.6, 1.2, size=(batch, 1, 1)) / radius[:, None, None]
    b = rng.normal(size=(batch, nz, m))
    q = np.zeros((batch, nz, nz))
    q[: batch // 2] = np.diag([10.0] * min(2, nz) + [0.0] * (nz - 2))
    q[batch // 2:] = 10.0 * np.eye(nz)
    r = 0.01 * np.eye(m)
    return tuple(torch.tensor(v) for v in (a, b, q, r))


def with_faults(a, b, q, r):
    """Scenario 1 gets a NaN in A; scenario 2 gets B = e_0, R = 1 and
    Q = -e_0 e_0', so that G H = -e_0 e_0' exactly and I + G H has a zero
    first column; Q and R are then batched."""
    a, b = a.clone(), b.clone()
    q = q.expand(a.shape).clone()
    r = r.expand((a.shape[0],) + r.shape[-2:]).clone()
    a[1, 2, 3 % a.shape[-1]] = float("nan")
    b[2] = 0.0
    b[2, 0, 0] = 1.0
    q[2] = 0.0
    q[2, 0, 0] = -1.0
    r[2] = torch.eye(r.shape[-1], dtype=r.dtype)
    return a, b, q, r


def model_of(a, b):
    return LinearModel(a, b, a.new_zeros(a.shape[:-2] + (1, a.shape[-1])))


def plain(a, b, q, r, iters=30):
    """(P, K, gamma) by ``synthesize_terminal``'s plain route."""
    return tuple(terminal.synthesize_terminal(model_of(a, b), q, r, iters))


def assert_bitwise(got, ref):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


# ---- the plain version (CPU) ----

@pytest.mark.parametrize("faults", [False, True], ids=["models", "faults"])
@pytest.mark.parametrize("name", PRESETS)
def test_plain_version_is_the_composition(preset_models, name, faults):
    """On CPU tensors ``synthesize_terminal``'s kernel route gives the
    plain route's certificate bit for bit, on the presets' models and with
    a NaN in A and an exactly singular I + G H, where P, K and gamma are
    non-finite in those scenarios and finite in the others."""
    a, b, q, r = preset_models[name]
    if faults:
        a, b, q, r = with_faults(a, b, q, r)
    for dtype in (F64, F32):
        args = [t.to(dtype) for t in (a, b, q, r)]
        ref = plain(*args)
        kern = terminal.synthesize_terminal(model_of(args[0], args[1]),
                                            args[2], args[3], kernel=True)
        assert_bitwise(kern, ref)
        finite = [torch.isfinite(v.reshape(B, -1)).all(-1) for v in ref]
        if faults:
            for f in finite:
                assert not f[1] and not f[2]
        if dtype == F64:
            for f in finite:
                assert f[0] and f[3:].all()


def test_tie_case_tells_the_pivot_orders_apart():
    """The tie case of the card test below (B = R = A = I, one doubling
    step, ties in the first column of I + Q) gives another float32 P
    where the pivot of a tie is the last row, so bit equality on it checks
    the rule."""
    a, b, q, r = tie_case(F32)
    first = plain(a, b, q, r, iters=1)[0]

    def gj_last(m):
        n = m.shape[-1]
        aug = torch.cat([m, torch.eye(n, dtype=m.dtype).expand(m.shape)], -1)
        for j in range(n):
            col = aug[0, j:, j].abs()
            p = j + int(torch.nonzero(col == col.max()).max())
            order = list(range(n))
            order[j], order[p] = p, j
            aug = aug[:, order]
            d = aug[:, j, j:j + 1]
            piv = aug[:, j, :] / d
            factor = aug[:, :, j].clone()
            factor[:, j] = d[:, 0] - 1.0
            aug = aug - factor[:, :, None] * piv[:, None, :]
        return aug[..., n:]

    saved = dare.gj_solve
    dare.gj_solve = lambda m, rhs: gj_last(m) @ rhs
    try:
        last = plain(a, b, q, r, iters=1)[0]
    finally:
        dare.gj_solve = saved
    assert not torch.equal(first, last)


def tie_case(dtype, device="cpu"):
    """B = R = A = I (m = nz = 3), Q with one nonzero a column, so that
    every product of one doubling step is exact and I + Q has a tie in its
    first column (1 and -1)."""
    eye = torch.eye(3, dtype=dtype, device=device)[None]
    q = torch.zeros(1, 3, 3, dtype=dtype, device=device)
    q[0, 1, 0], q[0, 2, 1], q[0, 0, 2] = -1.0, 3.0, 5.0
    return eye, eye, q, eye[0]


# ---- the route ----

ROUTES = {  # (kernel flag, nz, m) -> takes the kernel route
    "kernel": (True, 10, 1, True),
    "plain": (False, 10, 1, False),
    "nz33": (True, 33, 1, False),
    "m5": (True, 6, 5, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_choice(case, monkeypatch):
    """``synthesize_terminal`` takes the kernel route only with
    ``kernel=True`` and nz <= 32, m <= 4, and counts the rows it sends
    there (``terminal.kernel_rows``) beside none otherwise; on CPU tensors
    that route runs the plain synthesis and never calls the kernel's
    wrapper; the engine sets ``kernel`` on ``qp_backend='pallas'``."""
    kernel, nz, m, expect = ROUTES[case]
    a, b, q, r = random_pairs(3, nz, m, seed=nz + m)
    calls = []
    monkeypatch.setattr(terminal.kernel_route, "dare_terminal",
                        lambda *args, **kwargs: calls.append(args))
    profiling.enable(True)
    try:
        cert = terminal.synthesize_terminal(model_of(a, b), q, r,
                                            kernel=kernel)
        counted = profiling.counters().get("terminal.kernel_rows", 0)
    finally:
        profiling.enable(False)
    assert not calls
    assert counted == (3 if expect else 0)
    assert_bitwise(cert, plain(a, b, q, r))
    a_grad = a.clone().requires_grad_(True)
    if expect:
        with pytest.raises(ValueError, match="no gradient"):
            terminal.synthesize_terminal(model_of(a_grad, b), q, r,
                                         kernel=kernel)
    else:
        cert = terminal.synthesize_terminal(model_of(a_grad, b), q, r,
                                            kernel=kernel)
        assert cert.gamma.requires_grad


def run_revise2_vdp(backend, device, batch=2, steps=1):
    """``revise2_vdp`` on ``backend`` for ``steps`` steps of ``batch``
    scenarios."""
    from koopmanx_torch.engine.scenario import sample_scenarios
    from koopmanx_torch.run import run_scenarios
    from koopmanx_torch.systems.library import get_system

    cfg = C.PRESETS["revise2_vdp"]()
    cfg.steps = steps
    cfg.mpc.qp_backend = backend
    pipe = build_pipeline(cfg, device=device)
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), batch,
                          param_scale=0.15, dtype=F32, device=device)
    return run_scenarios(pipe, sc)


def test_engine_sets_the_route_from_the_backend(monkeypatch):
    """A step of ``revise2_vdp`` asks for the kernel route on
    ``qp_backend='pallas'`` and for the plain one on ``'xla'``."""
    from koopmanx_torch.engine import core

    seen = []
    real = core.synthesize_terminal

    def spy(*args, **kwargs):
        seen.append(kwargs.get("kernel", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(core, "synthesize_terminal", spy)
    run_revise2_vdp("pallas", "cpu")
    on_kernel, seen[:] = list(seen), []
    run_revise2_vdp("xla", "cpu")
    assert on_kernel and all(on_kernel)
    assert seen and not any(seen)


# ---- the wrapper's refusals ----

def _args(dtype=F64):
    return list(random_pairs(4, 5, 2, seed=1))


REFUSALS = {
    "float16": (lambda a, b, q, r: [t.half() for t in (a, b, q, r)],
                TypeError),
    "int": (lambda a, b, q, r: [t.long() for t in (a, b, q, r)], TypeError),
    "mixed_dtype": (lambda a, b, q, r: [a, b, q.float(), r], TypeError),
    "device": (lambda a, b, q, r: [a, b, q.to("meta"), r], ValueError),
    "b_shape": (lambda a, b, q, r: [a, b[:, :4], q, r], ValueError),
    "a_not_square": (lambda a, b, q, r: [a[:, :4], b, q, r], ValueError),
    "q_shape": (lambda a, b, q, r: [a, b, q[:, :4, :4], r], ValueError),
    "r_shape": (lambda a, b, q, r: [a, b, q, r[:1, :1]], ValueError),
    "unbatched": (lambda a, b, q, r: [a[0], b[0], q, r], ValueError),
    "a_columns": (lambda a, b, q, r: [a.transpose(1, 2), b, q, r],
                  ValueError),
    "q_columns": (lambda a, b, q, r: [a, b, q.transpose(1, 2), r],
                  ValueError),
    "nz33": (lambda a, b, q, r: list(random_pairs(2, 33, 1, 2)), ValueError),
    "m5": (lambda a, b, q, r: list(random_pairs(2, 6, 5, 2)), ValueError),
    "cpu": (lambda a, b, q, r: [a, b, q, r], ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses(case):
    """A dtype other than float32 / float64, two dtypes or devices, a wrong
    shape, rows that are not unit-stride, nz > 32 or m > 4 raise before
    any work, each for its own fault; then tensors off a CUDA device."""
    make, exc = REFUSALS[case]
    with pytest.raises(exc) as raised:
        dt.dare_terminal(*make(*_args()))
    assert ("runs on a CUDA device" in str(raised.value)) == (case == "cpu")


def test_wrapper_refuses_autograd():
    """Under autograd the wrapper raises (the kernel has no gradient)
    before anything else; under ``no_grad`` it goes on to its other
    checks (here: CPU tensors)."""
    a, b, q, r = _args()
    a_grad = a.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        dt.dare_terminal(a_grad, b, q, r)
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="runs on a CUDA device"):
        dt.dare_terminal(a_grad, b, q, r)


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
    diff = (got - ref).abs().amax(dim=axes) if axes else (got - ref).abs()
    scale = ref.abs().amax(dim=axes) if axes else ref.abs()
    return diff / scale.clamp_min(1e-300)


WIDTHS = [(10, 1, 65), (8, 1, 64), (3, 2, 37), (16, 4, 9), (32, 1, 5),
          (1, 1, 70)]


@pytest.mark.parametrize("nz,m,batch", WIDTHS,
                         ids=[f"nz{n}_m{m}_b{b}" for n, m, b in WIDTHS])
def test_kernel_matches_plain_float64(card, nz, m, batch):
    """float64: P, K and gamma within 1e-9 of each scenario's largest
    |entry|, at widths where segments fill a warp (8), leave lanes over
    (10, 3), take one warp a scenario (16, 32) or one lane (1), batches
    that end inside a warp, Q batched and R shared."""
    a, b, q, r = (t.to(card) for t in random_pairs(batch, nz, m, seed=nz))
    before = dt.dare_terminal.launches
    got = dt.dare_terminal(a, b, q, r)
    assert dt.dare_terminal.launches == before + 1
    ref = plain(a, b, q, r)
    for g, rr in zip(got, ref):
        assert torch.isfinite(rr).all()
        assert (rel_err(g, rr) <= 1e-9).all()


@pytest.mark.parametrize("name", PRESETS)
def test_kernel_matches_plain_float64_on_presets(card, preset_models, name):
    """float64 on the presets' models, Q and R expanded to the batch
    (batch stride 0, as the engine passes them): within 1e-9."""
    a, b, q, r = (t.to(card) for t in preset_models[name])
    q, r = q.expand((B,) + q.shape), r.expand((B,) + r.shape)
    got = dt.dare_terminal(a, b, q, r)
    for g, rr in zip(got, plain(a, b, q, r)):
        assert (rel_err(g, rr) <= 1e-9).all()


def test_nonfinite_propagates(card, preset_models):
    """A NaN and an Inf in A, and an exactly singular I + G H: where the
    plain version's P, K or gamma is non-finite the kernel's is too (the
    engine's certificate guard holds the last certificate on that), and
    the other scenarios stay finite, in float64 and float32."""
    a, b, q, r = with_faults(*preset_models["revise2_duffing"])
    a[3, 0, 0] = float("inf")
    for dtype in (F64, F32):
        args = [t.to(card, dtype) for t in (a, b, q, r)]
        got, ref = dt.dare_terminal(*args), plain(*args)
        for g, rr in zip(got, ref):
            bad_ref = ~torch.isfinite(rr.reshape(B, -1)).all(-1)
            bad_got = ~torch.isfinite(g.reshape(B, -1)).all(-1)
            assert bad_ref[1:4].all()
            assert torch.equal(bad_got, bad_ref)


def test_pivot_ties_go_to_the_first_row(card):
    """On the tie case (every product of the step exact, a tie in the
    first column of I + Q) the kernel's P equals the plain version's bit
    for bit, in float32 and float64, on the card and against the CPU; a
    last-row rule gives another float32 P (the CPU test above)."""
    for dtype in (F32, F64):
        got = dt.dare_terminal(*tie_case(dtype, card), iters=1)[0]
        ref = plain(*tie_case(dtype, card), iters=1)[0]
        cpu = plain(*tie_case(dtype), iters=1)[0]
        assert torch.equal(got, ref)
        assert torch.equal(got.cpu(), cpu)


def test_engine_launches_the_kernel_once_a_step(card):
    """``revise2_vdp`` on the card: three steps launch the kernel three
    times on ``qp_backend='pallas'`` and never on ``'xla'``."""
    before = dt.dare_terminal.launches
    run_revise2_vdp("pallas", card, batch=8, steps=3)
    assert dt.dare_terminal.launches == before + 3
    run_revise2_vdp("xla", card, batch=8, steps=3)
    assert dt.dare_terminal.launches == before + 3


def vdp_loop_models(steps=60, batch=8):
    """The online-updated models the ``revise2_vdp`` loop synthesizes from
    (CPU, float32), with the plain gamma of each: (A, B, gamma), float64,
    those with a finite gamma. Their levels depend on the host's float32
    arithmetic along the loop: 5.7e4-3.7e5 on one machine, past 1e14 on
    another."""
    from koopmanx_torch.engine import core

    seen = []
    real = core.synthesize_terminal

    def spy(model, q, r, *args, **kwargs):
        out = real(model, q, r, *args, **kwargs)
        seen.append((model.A.to(F64), model.B.to(F64), out.gamma.to(F64)))
        return out

    core.synthesize_terminal = spy
    try:
        run_revise2_vdp("xla", "cpu", batch=batch, steps=steps)
    finally:
        core.synthesize_terminal = real
    a, b, g = (torch.cat(v) for v in zip(*seen))
    keep = torch.isfinite(g)
    return a[keep], b[keep], g[keep]


def scaled_vdp_models(preset_models):
    """``revise2_vdp``'s batch model with A scaled by 1-1.5 and B by 1 to
    1e-3 (24 scenarios): float64 gamma from 5.7e4 past 1e15, a model
    less controllable and less stable with each step, as the loop's
    online models become when the estimate drifts."""
    a, b, q, r = preset_models["revise2_vdp"]
    fs = torch.tensor([1.0, 1.05, 1.1, 1.2, 1.3, 1.5], dtype=F64)
    ss = torch.tensor([1.0, 1e-1, 1e-2, 1e-3], dtype=F64)
    nz = a.shape[-1]
    a = (a[0] * fs[:, None, None, None]).expand(6, 4, nz, nz)
    b = (b[0] * ss[None, :, None, None]).expand(6, 4, nz, 1)
    return a.reshape(24, nz, nz), b.reshape(24, nz, 1), q, r


def test_kernel_float32_within_plain_round_off(card, preset_models):
    """float32 against the plain version in float32 on the card, on the
    presets' models, the ``revise2_vdp`` loop's online models and the
    scaled VDP models (float64 gamma past 1e12): the same scenarios
    non-finite, and each scenario's P, K and gamma within FLOAT32_RTOL of
    its largest |entry| or within ten times the plain version's own
    change there when A moves by one float32 ulp (up, then down), where
    that is larger. The DARE amplifies the model's round-off (PERF.md,
    section 2): on the ill-conditioned models that change reaches the
    size of P itself, so no fixed tolerance holds both them and the
    presets' models."""
    va, vb, _ = vdp_loop_models()
    scaled = scaled_vdp_models(preset_models)
    gamma = plain(*scaled)[2]
    assert (gamma > 1e12).any() and torch.isfinite(gamma[:20]).all()
    _, _, q, r = preset_models["revise2_vdp"]
    sets = [preset_models["revise2_duffing"], preset_models["revise2_vdp"],
            (va, vb, q, r), scaled]
    for a, b, q, r in sets:
        a, b, q, r = (t.to(card, F32) for t in (a, b, q, r))
        got, ref = dt.dare_terminal(a, b, q, r), plain(a, b, q, r)
        nudged = [plain(torch.nextafter(a, torch.full_like(a, t)), b,
                              q, r) for t in (float("inf"), -float("inf"))]
        for i, (g, rr) in enumerate(zip(got, ref)):
            bad = ~torch.isfinite(rr.reshape(rr.shape[0], -1)).all(-1)
            assert torch.equal(bad, ~torch.isfinite(
                g.reshape(g.shape[0], -1)).all(-1))
            g, rr = g[~bad].to(F64), rr[~bad].to(F64)
            axes = tuple(range(1, rr.dim()))
            amax = (lambda t: t.abs().amax(dim=axes)) if axes else torch.abs
            floor = torch.stack([amax(v[i][~bad].to(F64) - rr)
                                 for v in nudged]).amax(0)
            floor = torch.nan_to_num(floor, nan=float("inf"))
            bound = torch.maximum(FLOAT32_RTOL * amax(rr), 10.0 * floor)
            assert (amax(g - rr) <= bound).all(), (
                i, (amax(g - rr) / amax(rr)).max())
