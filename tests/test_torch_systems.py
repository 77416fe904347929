"""koopmanx_torch plants, scenarios and device rules against the JAX package.

Inputs come from numpy with a seed and go through both packages in
float64. RK4 is the same sequence of elementwise operations in both, so
the tolerance is 1e-12 (a few ulps of the states, which stay O(1))."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx.systems import base as jbase  # noqa: E402
from koopmanx.systems import library as jlib  # noqa: E402
from koopmanx.systems.data import rollout as jrollout  # noqa: E402

from koopmanx_torch.device import resolve_device  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.systems import base as tbase  # noqa: E402
from koopmanx_torch.systems import library as tlib  # noqa: E402
from koopmanx_torch.systems.data import collect, rollout  # noqa: E402

F64 = torch.float64


def _theta(rng, batch):
    nominal = np.array([-0.5, 1.0, -1.0])
    return nominal * (1.0 + rng.uniform(-0.15, 0.15, size=(batch, 3)))


def test_rk4_step_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(16, 2))
    u = rng.uniform(-2, 2, size=(16, 1))
    th = _theta(rng, 16)
    jstep = jbase.make_step(jlib.DUFFING, 0.05)
    ref = jax.vmap(lambda xx, uu, t: jstep(xx, uu, jlib.DuffingParams(*t)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(th))
    tstep = tbase.make_step(tlib.DUFFING, 0.05)
    out = tstep(torch.tensor(x), torch.tensor(u),
                tlib.DuffingParams(*torch.tensor(th).T))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_duffing_rollout_200_steps_matches_jax():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-2, 2, size=(4, 2))
    u = rng.uniform(-2, 2, size=(4, 200, 1))
    jstep = jbase.make_step(jlib.DUFFING, 0.05)
    theta = jlib.DUFFING.theta0
    jx, jy = jax.vmap(lambda a, b: jrollout(jstep, a, b, theta))(
        jnp.asarray(x0), jnp.asarray(u))
    tstep = tbase.make_step(tlib.DUFFING, 0.05)
    tx, ty = rollout(tstep, torch.tensor(x0), torch.tensor(u),
                     tbase.as_params(tlib.DUFFING.theta0, F64,
                                     torch.device("cpu")))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-12)


def test_switch_schedule_is_strict():
    """theta1 only once step > switch_step, as the JAX schedule."""
    jsched = jbase.make_switch_schedule(jnp.asarray(0.0), jnp.asarray(1.0), 5)
    tsched = tbase.make_switch_schedule("theta0", "theta1", 5)
    for step in (4, 5, 6):
        want = "theta1" if float(jsched(jnp.asarray(step))) == 1.0 else "theta0"
        assert tsched(step) == want


def test_collect_layout_and_determinism():
    gen = lambda: torch.Generator().manual_seed(3)
    a = collect(tlib.DUFFING, gen(), n_step=7, n_traj=5, dtype=F64)
    b = collect(tlib.DUFFING, gen(), n_step=7, n_traj=5, dtype=F64)
    assert a.x.shape == (35, 2) and a.u.shape == (35, 1)
    np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
    # trajectory-major: y of step t is x of step t+1 within a trajectory
    np.testing.assert_array_equal(a.y.numpy()[:6], a.x.numpy()[1:7])
    assert float(a.u.abs().max()) <= 2.0


def test_sample_scenarios_ranges():
    sc = sample_scenarios(tlib.DUFFING, torch.Generator().manual_seed(0), 256,
                          param_scale=0.15, dtype=F64, device="cpu")
    assert sc.x0.shape == (256, 2)
    assert float(sc.x0.abs().max()) <= 2.0
    for leaf, nominal in zip(sc.theta0, tlib.DUFFING.theta0):
        ratio = (leaf / nominal).numpy()
        assert ratio.min() >= 0.85 and ratio.max() <= 1.15
        assert leaf.shape == (256,)


def test_unported_system_raises():
    """Every plant of the JAX registry is ported: approach3 (item 18, the
    training file's plant) steps finite from the registry, and an unknown
    name raises KeyError."""
    from koopmanx.systems.library import REGISTRY as JREGISTRY

    assert set(tlib.REGISTRY) == set(JREGISTRY)
    for name in ("approach3",):
        system = tlib.get_system(name)
        x = tbase.make_step(system, 0.05)(
            torch.full((4, 2), 0.5, dtype=F64), torch.zeros((4, 1), dtype=F64),
            tbase.as_params(system.theta0, F64, torch.device("cpu")))
        assert x.shape == (4, 2) and bool(torch.isfinite(x).all())
    with pytest.raises(KeyError, match="unknown system"):
        tlib.get_system("no_such_plant")


def test_entry_points_want_cuda_unless_asked_for_cpu():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_port_imports_no_jax_and_nothing_of_koopmanx():
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parent.parent
    pattern = re.compile(r"^\s*(import|from)\s+(jax|koopmanx)(\.|\s|$)", re.M)
    files = [p for p in sorted((root / "koopmanx_torch").rglob("*.py"))
             if "_build" not in p.parts] + [root / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA it exits non-zero and prints no result; alone in a
    directory (without the package beside it) it does the same."""
    import pathlib
    import shutil
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    script = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    shutil.copy(script, tmp_path / "chip_smoke.py")
    for where in (script, tmp_path / "chip_smoke.py"):
        out = subprocess.run([sys.executable, str(where)], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and out.stdout == "", (where, out)
