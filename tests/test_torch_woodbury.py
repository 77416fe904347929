"""The Woodbury lane of the windowed estimator and the compressed ring, in
koopmanx_torch, against the JAX package: the carried statistics' rank-2
update (Sherman-Morrison and the Newton-Schulz polish), its divergence
safeguard, the exact rebuild, the model from the carried inverses, the
bf16/f16 ring with its quantize-before-use rule, the refit on a
compressed ring, and the engine's Woodbury branch with the model guard.
Batched over scenarios in the port, ``vmap``-ed in JAX; inputs from numpy
with a seed."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.edmd import windowed as jwin  # noqa: E402
from koopmanx.engine import core as jcore  # noqa: E402
from koopmanx.types import LinearModel as JModel  # noqa: E402

from koopmanx_torch.edmd import windowed as twin  # noqa: E402
from koopmanx_torch.engine import core as tcore  # noqa: E402
from koopmanx_torch.run import replicate  # noqa: E402
from koopmanx_torch.types import LinearModel as TModel  # noqa: E402

W, NLIFT, M, N, B = 16, 6, 1, 2, 3
D = NLIFT + M
RIDGE = 1e-1
CARRIED = ("g", "g_inv", "gz", "gz_inv", "mg", "mc")
RINGS = ("zx", "u", "zy", "x")
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are a few scenarios wide, and
    a thread pool beside JAX's only adds contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _states(dtype, seed, store=None, cursors=(0, 5, W - 1)):
    """The same prefilled Woodbury state in both packages (the carried
    statistics built from a full ring), one scenario per cursor."""
    rng = np.random.default_rng(seed)
    snap = [rng.normal(size=(W + 5, k)) for k in (NLIFT, M, NLIFT, N)]
    j0 = jwin.window_prefill(
        jwin.window_init(W, NLIFT, M, N, JDT[dtype], carry=True, ridge=RIDGE,
                         store_dtype=None if store is None else JDT[store]),
        *(jnp.asarray(a, JDT[dtype]) for a in snap))
    t0 = twin.window_prefill(
        twin.window_init(W, NLIFT, M, N, dtype, carry=True, ridge=RIDGE,
                         store_dtype=store),
        *(torch.tensor(a, dtype=dtype) for a in snap))
    b = len(cursors)
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (b,) + a.shape), j0)._replace(
            idx=jnp.asarray(cursors, jnp.int32))
    tstate = replicate(t0, b)._replace(
        idx=torch.tensor(cursors, dtype=torch.int32))
    return jstate, tstate


def _obs(rng, dtype):
    """One observation (z, u, z+, x target) per scenario."""
    return [rng.normal(size=(B, k)).astype(
        np.float32 if dtype == torch.float32 else np.float64)
        for k in (NLIFT, M, NLIFT, N)]


@functools.lru_cache(maxsize=None)
def _j_update(polish):
    return jax.jit(jax.vmap(functools.partial(jwin.window_update_carry,
                                              polish=polish)))


def _assert_close(t_state, j_state, rtol, fields=CARRIED + RINGS):
    """Each field within ``rtol`` of the JAX one, relative to the field's
    largest magnitude (at least 1)."""
    for k in fields:
        ref = _jnp(getattr(j_state, k))
        out = _np(getattr(t_state, k))
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("dtype,polish", [
    pytest.param(torch.float64, 1, id="f64-polish1"),
    pytest.param(torch.float64, 2, id="f64-polish2"),
    pytest.param(torch.float32, 1, id="f32-polish1"),
    pytest.param(torch.float32, 2, id="f32-polish2")])
def test_window_update_carry_matches_jax(dtype, polish):
    """60 steps (the ring wraps almost four times) from three cursors:
    every carried field and ring against JAX after every 10th step, to
    1e-10 in float64 and 1e-4 in float32, relative to the field's scale
    (the same arithmetic up to summation order; the polish contracts the
    difference each step). The rings and cursors are copies: equal."""
    rng = np.random.default_rng(polish)
    jstate, tstate = _states(dtype, seed=polish)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    for step in range(60):
        obs = _obs(rng, dtype)
        jstate = _j_update(polish)(jstate, *(jnp.asarray(a) for a in obs))
        before = tstate
        tstate = twin.window_update_carry(
            tstate, *(torch.tensor(a) for a in obs), polish=polish)
        if step % 10 == 9:
            _assert_close(tstate, jstate, tol)
            for k in RINGS + ("idx",):
                np.testing.assert_array_equal(_np(getattr(tstate, k)),
                                              np.asarray(getattr(jstate, k)))
    assert tstate.g.dtype == dtype and tstate.idx.dtype == torch.int32
    assert tstate.idx.tolist() == [(c + 60) % W for c in (0, 5, W - 1)]
    assert before.idx.tolist() != tstate.idx.tolist()  # out of place


def test_window_model_carry_matches_the_exact_refit():
    """41 steps in float64 (2.5 wraps), polish 1: the model from the
    carried inverses equals the exact refit of the same ring
    (``window_model(schulz_iters=0)``) to 1e-9, and the exact rebuild
    (``window_reanchor``) is a fixed point of the carried statistics
    (``tests/test_sqrt_rls.py::test_window_carry_woodbury_matches_exact_refit``
    for the JAX package)."""
    rng = np.random.default_rng(3)
    _, state = _states(torch.float64, seed=3)
    for _ in range(41):
        state = twin.window_update_carry(
            state, *(torch.tensor(a) for a in _obs(rng, torch.float64)))
    carried = twin.window_model_carry(state, NLIFT)
    exact = twin.window_model(state, NLIFT, ridge=RIDGE, schulz_iters=0)
    for a, b in zip(carried, exact):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)
    rebuilt = twin.window_reanchor(state, RIDGE)
    for k in CARRIED:
        np.testing.assert_allclose(getattr(rebuilt, k).numpy(),
                                   getattr(state, k).numpy(), rtol=0,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_window_model_carry_and_reanchor_match_jax(dtype):
    """After 20 steps, the model from the carried statistics and the exact
    rebuild from the rings (``spd_inverse``) against JAX: 1e-10 in
    float64, 1e-4 in float32, relative to each field's scale."""
    rng = np.random.default_rng(5)
    jstate, tstate = _states(dtype, seed=5)
    for _ in range(20):
        obs = _obs(rng, dtype)
        jstate = _j_update(1)(jstate, *(jnp.asarray(a) for a in obs))
        tstate = twin.window_update_carry(tstate,
                                          *(torch.tensor(a) for a in obs))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    jm = jax.vmap(lambda s: jwin.window_model_carry(s, NLIFT))(jstate)
    tm = twin.window_model_carry(tstate, NLIFT)
    for t, j in zip(tm, jm):
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=tol * scale)
    jre = jax.vmap(lambda s: jwin.window_reanchor(s, RIDGE))(jstate)
    tre = twin.window_reanchor(tstate, RIDGE)
    _assert_close(tre, jre, tol)
    assert tre.g.dtype == dtype


@pytest.mark.parametrize("corruption", [1e12, np.inf], ids=["x1e12", "xinf"])
def test_divergence_safeguard_recovers(corruption):
    """float32, polish 1, window 32, nlift 8, as
    ``tests/test_sqrt_rls.py::test_window_carry_divergence_recovery``: after
    60 steps, scenario 0's carried inverse is multiplied by 1e12 (the
    observed f32 blow-up on its way to inf) or by inf (Sherman-Morrison
    then gives NaN). The residual of the polish flags it, it restarts
    from the Schulz seed, and 60 more steps of polish reconverge it
    (max |G G^-1 - I| < 1e-2); it never goes non-finite. The restart is
    per scenario: scenario 1 runs bit for bit as without the corruption.
    The first step after the corruption selects the seed in both
    packages: the port within 1e-4 of JAX, relative."""
    w, nlift = 32, 8
    d = nlift + M
    rng = np.random.default_rng(9)
    jstate = jwin.window_init(w, nlift, M, N, jnp.float32, carry=True,
                              ridge=3e-2)
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (2,) + a.shape), jstate)
    tstate = replicate(twin.window_init(w, nlift, M, N, torch.float32,
                                        carry=True, ridge=3e-2), 2)
    obs = lambda: [rng.normal(size=(2, k)).astype(np.float32)
                   for k in (nlift, M, nlift, N)]
    for _ in range(60):
        o = obs()
        jstate = _j_update(1)(jstate, *(jnp.asarray(a) for a in o))
        tstate = twin.window_update_carry(tstate, *(torch.tensor(a) for a in o))
    scale = torch.tensor([corruption, 1.0], dtype=torch.float32)[:, None, None]
    tbad = tstate._replace(g_inv=tstate.g_inv * scale)
    jbad = jstate._replace(g_inv=jstate.g_inv * jnp.asarray(scale.numpy()))
    clean = tstate
    for step in range(60):
        o = obs()
        tbad = twin.window_update_carry(tbad, *(torch.tensor(a) for a in o))
        clean = twin.window_update_carry(clean, *(torch.tensor(a) for a in o))
        assert torch.isfinite(tbad.g_inv).all(), step
        if step == 0:
            jbad = _j_update(1)(jbad, *(jnp.asarray(a) for a in o))
            ref = np.asarray(jbad.g_inv)
            np.testing.assert_allclose(
                tbad.g_inv.numpy(), ref, rtol=0,
                atol=1e-4 * float(np.abs(ref).max()))
            # the seed G' / (||G||_1 ||G||_inf), symmetrized
            g = tbad.g[0].double()
            seed = g.T / (g.abs().sum(0).max() * g.abs().sum(1).max())
            np.testing.assert_allclose(tbad.g_inv[0].double().numpy(),
                                       (0.5 * (seed + seed.T)).numpy(),
                                       rtol=1e-5, atol=0)
    for k in CARRIED + RINGS:
        np.testing.assert_array_equal(getattr(tbad, k)[1].numpy(),
                                      getattr(clean, k)[1].numpy())
    res = (tbad.g[0].double() @ tbad.g_inv[0].double()
           - torch.eye(d, dtype=torch.float64)).abs().max()
    assert float(res) < 1e-2, float(res)


@pytest.mark.parametrize("store", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_compressed_ring_matches_jax(store):
    """A bf16 or f16 ring with float32 statistics, 40 steps (2.5 wraps),
    polish 1: the rings equal JAX's bit for bit (both quantize the same
    float32 rows), the carried statistics within 1e-4 of JAX's relative
    to their scale; every evicted row is bit-identical to the quantized
    row added W steps before (the quantize-before-use rule), so the exact
    rebuild from the ring agrees with the carried Grams (2e-4, as in
    ``tests/test_sqrt_rls.py::test_window_bf16_ring_consistency``)."""
    rng = np.random.default_rng(17)
    jstate, tstate = _states(torch.float32, seed=17, store=store)
    assert tstate.zx.dtype == store and tstate.g.dtype == torch.float32
    added = {}
    for step in range(40):
        obs = _obs(rng, torch.float32)
        i = tstate.idx.long()
        rows = torch.arange(B)
        if step >= W:  # every cursor now points at a row this run added
            for k, ring in zip(RINGS, (tstate.zx, tstate.u, tstate.zy,
                                       tstate.x)):
                evicted = ring[rows, i]
                assert torch.equal(evicted, added[(k, step - W)]), (k, step)
        for k, a in zip(RINGS, obs):
            added[(k, step)] = torch.tensor(a).to(store)
        jstate = _j_update(1)(jstate, *(jnp.asarray(a) for a in obs))
        tstate = twin.window_update_carry(tstate,
                                          *(torch.tensor(a) for a in obs))
    for k in RINGS:
        ring = getattr(tstate, k)
        assert ring.dtype == store
        np.testing.assert_array_equal(_np(ring), _jnp(getattr(jstate, k)))
    _assert_close(tstate, jstate, 1e-4, CARRIED)
    rebuilt = twin.window_reanchor(tstate, RIDGE)
    for k in ("g", "mg", "gz", "mc"):
        np.testing.assert_allclose(getattr(rebuilt, k).numpy(),
                                   getattr(tstate, k).numpy(), rtol=0,
                                   atol=2e-4, err_msg=k)


def test_window_model_computes_in_float32_on_a_bf16_ring():
    """The refit of a bf16 ring runs in float32 (the repair of the port's
    refit, which ran in the ring's dtype): it equals the refit of a
    float32 ring holding the same (quantized) values exactly, and JAX's
    refit of the bf16 ring to 1e-5 relative."""
    rng = np.random.default_rng(23)
    snap = [rng.normal(size=(W, k)).astype(np.float32)
            for k in (NLIFT, M, NLIFT, N)]
    bf = twin.window_prefill(
        twin.window_init(W, NLIFT, M, N, torch.float32,
                         store_dtype=torch.bfloat16),
        *(torch.tensor(a) for a in snap))
    f32 = bf._replace(**{k: getattr(bf, k).float() for k in RINGS})
    for iters in (0, 24):
        model = twin.window_model(bf, NLIFT, ridge=RIDGE, schulz_iters=iters)
        same = twin.window_model(f32, NLIFT, ridge=RIDGE, schulz_iters=iters)
        jbf = jwin.window_prefill(
            jwin.window_init(W, NLIFT, M, N, jnp.float32,
                             store_dtype=jnp.bfloat16),
            *(jnp.asarray(a) for a in snap))
        jm = jwin.window_model(jbf, NLIFT, ridge=RIDGE, schulz_iters=iters)
        for a, b, j in zip(model, same, jm):
            assert a.dtype == torch.float32
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("step", [2, 3])
def test_woodbury_estimator_update_matches_jax(step):
    """The engine's Woodbury branch at step 2 (no rebuild) and step 3
    ((step + 1) % window_anchor == 0 with window_anchor 4: the exact
    rebuild from the ring), polish 2, then the model from the carried
    statistics and the model guard. Scenario 1's observation is
    non-finite: it keeps its ring, cursor, carried statistics and model.
    Scenario 2's carried Gram holds an inf (its ring and observation are
    finite): at step 2 it is held likewise (the guard's finiteness sum
    covers the carried statistics); at step 3 the rebuild from its finite
    ring clears the inf and it advances. In both packages; float64, 1e-10
    relative to each field's scale."""
    rng = np.random.default_rng(step)
    obs = _obs(rng, torch.float64)
    obs[2][1, 0] = np.nan
    a0 = 0.5 * np.eye(NLIFT) + 0.05 * rng.normal(size=(B, NLIFT, NLIFT))
    b0, c0 = rng.normal(size=(B, NLIFT, M)), rng.normal(size=(B, N, NLIFT))
    kw = dict(update="windowed", window_carry="woodbury", window_polish=2,
              window_anchor=4, rls_ridge=RIDGE, model_guard=50.0)
    dummy = type("D", (), {"nlift": NLIFT})()
    jstate, tstate = _states(torch.float64, seed=step)
    poison = np.zeros((B, D, D))
    poison[2, 0, 0] = np.inf
    jstate = jstate._replace(g=jstate.g + jnp.asarray(poison))
    tstate = tstate._replace(g=tstate.g + torch.tensor(poison))
    jupd = jcore.make_estimator_update(dummy, jcore.EngineConfig(**kw))
    jr, jm = jax.vmap(lambda s, mm, *a: jupd(s, mm, *a, step))(
        jstate, JModel(*(jnp.asarray(v) for v in (a0, b0, c0))),
        *(jnp.asarray(v) for v in obs))
    tupd = tcore.make_estimator_update(dummy, tcore.EngineConfig(**kw))
    tr, tm = tupd(tstate, TModel(*(torch.tensor(v) for v in (a0, b0, c0))),
                  *(torch.tensor(v) for v in obs), step)
    for t, j in zip(tm, jm):
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-10 * scale)
    _assert_close(tr, jr, 1e-10)
    held = (1, 2) if step == 2 else (1,)
    assert tr.idx.tolist() == [1, 5, W - 1 if step == 2 else 0]
    assert bool(torch.isfinite(tr.g[2]).all()) == (step == 3)
    for i in held:
        np.testing.assert_array_equal(tm.A[i].numpy(), a0[i])
        for k in CARRIED + RINGS:
            np.testing.assert_array_equal(getattr(tr, k)[i].numpy(),
                                          getattr(tstate, k)[i].numpy())
    # the clean scenarios moved: their models come from the new statistics
    assert not np.array_equal(tm.A[0].numpy(), a0[0])


def test_sherman_morrison_matches_jax():
    """One add and one remove step on batched inverses against JAX's
    ``_sm_step``, including a removal of a row the window does not hold
    (c'Xc > 1), whose denominator is clamped at 1e-6 in both packages:
    1e-10 relative in float64."""
    rng = np.random.default_rng(29)
    v = rng.normal(size=(B, 3 * D, D))
    x = np.linalg.inv(np.einsum("bwi,bwj->bij", v, v) + RIDGE * np.eye(D))
    c = rng.normal(size=(B, D))
    c[2] *= 30.0  # far outside the window: 1 - c'Xc < 0
    assert np.einsum("i,ij,j->", c[2], x[2], c[2]) > 1.0
    for sign in (1.0, -1.0):
        ref = np.asarray(jax.vmap(lambda a, b: jwin._sm_step(a, b, sign))(
            jnp.asarray(x), jnp.asarray(c)))
        out = twin._sm_step(torch.tensor(x), torch.tensor(c), sign).numpy()
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


def test_safeguard_reads_the_residual_before_the_last_polish_step():
    """Inverses scaled by 1.7 before the update: for scenarios 1 and 2,
    r^2 = ||G X - I||^2 is below 4d before the polish step and above it
    after. The safeguard reads the residual before the last step, as JAX
    does, so neither is restarted: their inverses are polished on, not the
    seed. float64, 1e-10 relative against JAX."""
    rng = np.random.default_rng(31)
    jstate, tstate = _states(torch.float64, seed=31)
    jstate = jstate._replace(g_inv=1.7 * jstate.g_inv)
    tstate = tstate._replace(g_inv=1.7 * tstate.g_inv)
    obs = _obs(rng, torch.float64)
    jnew = _j_update(1)(jstate, *(jnp.asarray(a) for a in obs))
    tnew = twin.window_update_carry(tstate, *(torch.tensor(a) for a in obs))
    _assert_close(tnew, jnew, 1e-10, ("g_inv",))
    # the premise: the inverse the polish step starts from, and its result
    z, u, _, _ = (torch.tensor(a) for a in obs)
    rows, i = torch.arange(B), tstate.idx.long()
    v_new = torch.cat([z, u], -1)
    v_old = torch.cat([tstate.zx[rows, i], tstate.u[rows, i]], -1)
    start = twin._sm_step(twin._sm_step(tstate.g_inv, v_new, 1.0), v_old,
                          -1.0)
    g, eye = tnew.g, torch.eye(D, dtype=torch.float64)
    r2 = lambda x: ((g @ x - eye) ** 2).sum((-2, -1))
    polished = start @ (2.0 * eye - g @ start)
    assert (r2(start)[1:] < 4 * D).all() and (r2(polished)[1:] > 4 * D).all()
    seed = g.transpose(-1, -2) / (g.abs().sum(-2).amax(-1)
                                  * g.abs().sum(-1).amax(-1))[:, None, None]
    assert ((tnew.g_inv - seed).abs().amax((-2, -1)) > 1e-3).all()
    np.testing.assert_allclose(
        tnew.g_inv.numpy(),
        (0.5 * (polished + polished.transpose(-1, -2))).numpy(), rtol=0,
        atol=1e-10 * float(polished.abs().max()))
