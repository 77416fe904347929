"""The small API pieces of koopmanx_torch against the JAX package:
``edmd/batch.py`` (``lift_snapshots``, ``combine_gram_stats``,
``edmd_fit_pinv_direct``), ``engine/scenario.py::replicate_scenario``,
``systems/base.py::make_constant_schedule``,
``systems/data.py::from_reference_layout`` and ``types.ClosedLoopLog``;
then ``utils/profiling.py`` on the CPU. float64; inputs from numpy with a
seed."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from koopmanx import types as jtypes  # noqa: E402
from koopmanx.edmd import batch as jbatch  # noqa: E402
from koopmanx.engine import scenario as jscenario  # noqa: E402
from koopmanx.lifts import mlp as jmlp  # noqa: E402
from koopmanx.systems import base as jsys  # noqa: E402
from koopmanx.systems import data as jdata  # noqa: E402
from koopmanx.systems.library import DuffingParams as JDuffing  # noqa: E402

from koopmanx_torch import types as ttypes  # noqa: E402
from koopmanx_torch.edmd import batch as tbatch  # noqa: E402
from koopmanx_torch.engine import scenario as tscenario  # noqa: E402
from koopmanx_torch.lifts import mlp as tmlp  # noqa: E402
from koopmanx_torch.systems import base as tsys  # noqa: E402
from koopmanx_torch.systems import data as tdata  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams as TDuffing  # noqa: E402
from koopmanx_torch.utils import profiling  # noqa: E402

F64 = torch.float64


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol * np.maximum(1, np.abs(want))).all(), (
        np.abs(got - want).max())


@pytest.fixture(scope="module")
def lift_and_data():
    """A 2-16-16-16-6 MLP lift and 300 snapshot pairs of a 2-state,
    1-input plant, in both packages."""
    rng = np.random.default_rng(0)
    sizes = (2, 16, 16, 16, 6)
    params = [(rng.normal(size=(b, a)) / np.sqrt(a), 0.1 * rng.normal(size=b))
              for a, b in zip(sizes[:-1], sizes[1:])]
    x, y = rng.uniform(-2, 2, (300, 2)), rng.uniform(-2, 2, (300, 2))
    u = rng.uniform(-1, 1, (300, 1))
    jd = jmlp.encoder_dictionary([(jnp.asarray(w), jnp.asarray(b))
                                  for w, b in params], n=2)
    td = tmlp.encoder_dictionary(tmlp.MLP.from_params(
        [(torch.tensor(w), torch.tensor(b)) for w, b in params]), n=2)
    jsnap = jdata.Snapshots(*(jnp.asarray(a) for a in (x, y, u)))
    tsnap = tdata.Snapshots(*(torch.tensor(a) for a in (x, y, u)))
    return jd, td, jsnap, tsnap


def test_lift_snapshots_and_combined_grams_match_jax(lift_and_data):
    """The lifted pairs, and the Gram statistics of two halves combined,
    which equal those of the whole set; each against JAX's."""
    jd, td, jsnap, tsnap = lift_and_data
    with torch.no_grad():
        zx, zy = tbatch.lift_snapshots(td, tsnap)
        jzx, jzy = jbatch.lift_snapshots(jd, jsnap)
        _close(zx, jzx)
        _close(zy, jzy)
        half = lambda a, s: a[s]
        parts = [tbatch.gram_stats(half(zx, s), half(zy, s),
                                   half(tsnap.u, s), half(tsnap.x, s))
                 for s in (slice(0, 120), slice(120, None))]
        jparts = [jbatch.gram_stats(half(jzx, s), half(jzy, s),
                                    half(jsnap.u, s), half(jsnap.x, s))
                  for s in (slice(0, 120), slice(120, None))]
        both = tbatch.combine_gram_stats(*parts)
        jboth = jbatch.combine_gram_stats(*jparts)
        whole = tbatch.gram_stats(zx, zy, tsnap.u, tsnap.x)
    assert type(both) is tbatch.GramStats
    for a, b, c in zip(both, jboth, whole):
        _close(a, b)
        _close(a, c.numpy())
    assert float(both.count) == 300.0


def test_edmd_fit_pinv_direct_matches_jax(lift_and_data):
    """The direct pseudo-inverse fit against JAX's within 1e-10 of
    max(1, |entry|) (two SVD pseudo-inverses of 300-row snapshot
    matrices), and against the port's Gram fit."""
    jd, td, jsnap, tsnap = lift_and_data
    with torch.no_grad():
        model = tbatch.edmd_fit_pinv_direct(td, tsnap)
        gram = tbatch.edmd_fit(td, tsnap)
    jmodel = jbatch.edmd_fit_pinv_direct(jd, jsnap)
    for a, b, c in zip(model, jmodel, gram):
        assert a.shape == b.shape
        _close(a, b, 1e-10)
        _close(a, c.numpy(), 1e-6)


def test_replicate_scenario_matches_jax():
    x0, th0 = np.array([0.3, -1.2]), TDuffing(-0.5, 1.0, -1.0)
    th1 = TDuffing(-5.0, 2.0, -0.5)
    got = tscenario.replicate_scenario(x0, th0, th1, 5, F64, device="cpu")
    want = jscenario.replicate_scenario(x0, JDuffing(*th0), JDuffing(*th1),
                                        5, jnp.float64)
    assert type(got.theta0) is TDuffing
    _close(got.x0, want.x0, 0)
    for a, b in zip(got.theta0 + got.theta1, want.theta0 + want.theta1):
        _close(a, b, 0)


def test_constant_schedule_and_reference_layout_match_jax():
    """``make_constant_schedule`` gives its theta at every step;
    ``from_reference_layout`` of (n, S) matrices and a (S,) or (m, S)
    input gives JAX's row-major snapshots."""
    th = TDuffing(-0.5, 1.0, -1.0)
    sched = tsys.make_constant_schedule(th)
    jsched = jsys.make_constant_schedule(JDuffing(*th))
    for step in (0, 7, 10**6):
        assert sched(step) is th and tuple(jsched(step)) == tuple(th)
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=(2, 40)), rng.normal(size=(2, 40))
    for u in (rng.normal(size=40), rng.normal(size=(2, 40))):
        got = tdata.from_reference_layout(x, y, u)
        want = jdata.from_reference_layout(x, y, u)
        assert type(got) is tdata.Snapshots
        for a, b in zip(got, want):
            _close(a, b, 0)


def test_closed_loop_log_fields_match_jax():
    assert ttypes.ClosedLoopLog._fields == jtypes.ClosedLoopLog._fields
    log = ttypes.ClosedLoopLog(*(torch.zeros(3) for _ in range(7)))
    assert log.residual.shape == (3,)


def test_profiling_helpers_on_the_cpu(tmp_path):
    """``StepTimer`` accumulates each phase (a 20 ms sleep is 20 ms or
    more), ``solves_per_second`` is the rate, ``time_fn`` the best of its
    repeats, and ``trace`` writes its trace file."""
    timer = profiling.StepTimer(device="cpu")
    for _ in range(2):
        with timer.phase("sleep"):
            time.sleep(0.02)
        with timer.phase("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    rep = timer.report()
    assert rep["sleep"]["count"] == 2 and rep["sleep"]["total_s"] >= 0.04
    assert rep["sleep"]["mean_ms"] >= 20.0 and rep["matmul"]["count"] == 2
    assert profiling.solves_per_second(8192, 200, 2.0) == 8192 * 100
    calls = []
    best = profiling.time_fn(lambda: (calls.append(1), time.sleep(0.01)),
                             reps=3, device="cpu")
    assert len(calls) == 4 and 0.01 <= best < 1.0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
