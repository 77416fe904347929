"""koopmanx_torch lifts, EDMD, SPD inverse and square-root RLS against
the JAX package, on numpy inputs made from a seed, in float64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.edmd import batch as jbatch  # noqa: E402
from koopmanx.edmd import rls as jrls  # noqa: E402
from koopmanx.lifts import base as jlb  # noqa: E402
from koopmanx.lifts import mlp as jmlp  # noqa: E402
from koopmanx.ops.linalg import spd_inverse as j_spd_inverse  # noqa: E402

from koopmanx_torch.edmd import batch as tbatch  # noqa: E402
from koopmanx_torch.edmd import rls as trls  # noqa: E402
from koopmanx_torch.lifts import base as tlb  # noqa: E402
from koopmanx_torch.lifts.mlp import MLP, encoder_dictionary  # noqa: E402
from koopmanx_torch.ops.linalg import spd_inverse as t_spd_inverse  # noqa: E402


def _mlp_params(rng, sizes):
    return [
        (rng.normal(size=(o, i)) * np.sqrt(2.0 / i), rng.normal(size=(o,)) * 0.1)
        for i, o in zip(sizes[:-1], sizes[1:])
    ]


def _dicts(rng, hidden=16):
    params = _mlp_params(rng, (2, hidden, hidden, hidden, 8))
    jd = jmlp.encoder_dictionary(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params], n=2)
    td = encoder_dictionary(
        MLP.from_params([(torch.tensor(w), torch.tensor(b)) for w, b in params]),
        n=2)
    return jd, td


@torch.no_grad()
def test_mlp_encode_matches_jax():
    # matmul + bias + relu: sums of 16 products, 1e-12 covers reassociation
    rng = np.random.default_rng(0)
    jd, td = _dicts(rng)
    x = rng.uniform(-2, 2, size=(64, 2))
    np.testing.assert_allclose(td(torch.tensor(x)).numpy(),
                               np.asarray(jd(jnp.asarray(x))), rtol=0,
                               atol=1e-12)


@torch.no_grad()
def test_normalized_matches_jax():
    rng = np.random.default_rng(1)
    jd, td = _dicts(rng)
    xs = rng.uniform(-2, 2, size=(200, 2))
    jmu, jsc = jlb.fit_normalizer(jd, jnp.asarray(xs))
    tmu, tsc = tlb.fit_normalizer(td, torch.tensor(xs))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-12)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-12)
    x = rng.uniform(-2, 2, size=(32, 2))
    jn = jlb.normalized(jd, jmu, jsc)
    tn = tlb.normalized(td, tmu, tsc)
    np.testing.assert_allclose(tn(torch.tensor(x)).numpy(),
                               np.asarray(jn(jnp.asarray(x))), rtol=0,
                               atol=1e-12)


def _spd_batch(rng, batch=6, n=20, cond=1e3):
    q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    eig = np.geomspace(1.0, cond, n)
    return np.einsum("bij,j,bkj->bik", q, eig, q)


@pytest.mark.parametrize("block", [1, 8])
def test_spd_inverse_matches_jax(block):
    # cond 1e3 in f64: elimination rounding ~cond * eps, far below 1e-10
    k = _spd_batch(np.random.default_rng(2))
    ref = np.asarray(j_spd_inverse(jnp.asarray(k), block=block))
    out = t_spd_inverse(torch.tensor(k), block=block).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", k, out),
                               np.broadcast_to(np.eye(20), k.shape), atol=1e-10)


@torch.no_grad()
def test_edmd_pinv_fit_matches_jax():
    """pinv with JAX's cutoff (10 max(M,N) eps) on well-posed Grams."""
    rng = np.random.default_rng(3)
    jd, td = _dicts(rng)
    x = rng.uniform(-2, 2, size=(400, 2))
    y = x + 0.05 * rng.normal(size=(400, 2))
    u = rng.uniform(-2, 2, size=(400, 1))
    jstats = jbatch.gram_stats(jd(jnp.asarray(x)), jd(jnp.asarray(y)),
                               jnp.asarray(u), jnp.asarray(x))
    jm = jbatch.fit_from_grams(jstats, 8)
    tstats = tbatch.gram_stats(td(torch.tensor(x)), td(torch.tensor(y)),
                               torch.tensor(u), torch.tensor(x))
    tm = tbatch.fit_from_grams(tstats, 8)
    for a, b in zip(tm, jm):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(b).max()))


def test_sqrt_rls_300_updates_match_jax():
    """300 updates with the ridge trickle on both sides: the C-side ridge
    index is the post-increment count, so a one-off index drifts C."""
    rng = np.random.default_rng(4)
    nlift, m, n, steps, ridge = 8, 1, 2, 300, 1e-2
    z = rng.normal(size=(steps, nlift))
    u = rng.uniform(-2, 2, size=(steps, m))
    zn = rng.normal(size=(steps, nlift))
    xt = rng.normal(size=(steps, n))
    js = jrls.sqrt_rls_init(nlift, m, n, 1e4, 1e2, dtype=jnp.float64)
    ab = jax.jit(lambda s, a, b, c: jrls.sqrt_rls_update_ab(s, a, b, c, ridge=ridge))
    cc = jax.jit(lambda s, a, b: jrls.sqrt_rls_update_c(s, a, b, ridge=ridge))
    ts = trls.sqrt_rls_init(nlift, m, n, 1e4, 1e2, dtype=torch.float64)
    ts = ts._replace(**{k: v[None] for k, v in ts._asdict().items()})
    for k in range(steps):
        js = cc(ab(js, z[k], u[k], zn[k]), z[k], xt[k])
        t = lambda a: torch.tensor(a)[None]
        ts = trls.sqrt_rls_update_ab(ts, t(z[k]), t(u[k]), t(zn[k]), ridge=ridge)
        ts = trls.sqrt_rls_update_c(ts, t(z[k]), t(xt[k]), ridge=ridge)
    assert int(ts.count[0]) == int(js.count) == steps
    jm = jrls.sqrt_rls_model(js, nlift)
    tm = trls.sqrt_rls_model(ts, nlift)
    for a, b in zip(tm, jm):
        b = np.asarray(b)
        np.testing.assert_allclose(a[0].numpy(), b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())


def test_chol_rank1_update_zero_column_guard():
    rng = np.random.default_rng(5)
    r = np.triu(rng.normal(size=(5, 5))) + 3 * np.eye(5)
    r[2, :] = 0.0  # zero pivot row, and v is zero there too
    v = rng.normal(size=5)
    v[2] = 0.0
    ref = np.asarray(jrls.chol_rank1_update(jnp.asarray(r), jnp.asarray(v)))
    out = trls.chol_rank1_update(torch.tensor(r)[None], torch.tensor(v)[None])
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0, atol=1e-12)
