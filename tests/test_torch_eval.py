"""The evaluation helpers of koopmanx_torch (``eval/metrics.py``,
``eval/openloop.py``, ``eval/modes.py``, ``eval/persist.py``) against the
JAX package's on the same numpy inputs, and ``run.run_resumable`` against
``run.run_single``. float64 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import scipy.io as sio  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.eval import metrics as jmetrics  # noqa: E402
from koopmanx.eval.modes import spectrum_summary as j_spectrum  # noqa: E402
from koopmanx.eval.openloop import openloop_validate as j_openloop  # noqa: E402
from koopmanx.eval.persist import archive_run as j_archive  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.eval import metrics as tmetrics  # noqa: E402
from koopmanx_torch.eval.modes import (  # noqa: E402
    reconstruct_prediction,
    spectral_decomposition,
    spectrum_summary,
)
from koopmanx_torch.eval.openloop import openloop_validate  # noqa: E402
from koopmanx_torch.eval.persist import archive_run  # noqa: E402
from koopmanx_torch.run import build_pipeline, run_resumable, run_single  # noqa: E402
from koopmanx_torch.tree import tree_leaves  # noqa: E402

from test_torch_vdp import F64, arrays_from_jax  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _small(C, preset="duffing", steps=40):
    cfg = C.PRESETS[preset]()
    cfg.steps = steps
    cfg.dtype = "float64"
    cfg.switch_step = steps // 2
    cfg.data = C.DataConfig(n_step=40, n_traj=40)
    return cfg


@pytest.fixture(scope="module")
def pipes():
    """The JAX duffing pipeline and the port's on its arrays."""
    jpipe = j_build_pipeline(_small(JC))
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), _small(TC),
                               device="cpu", dtype=F64)
    return jpipe, pipe


def test_metrics_match_jax():
    """Every metric on the same numpy series, to 1e-12 relative."""
    rng = np.random.default_rng(0)
    y, r = rng.normal(size=(60,)), rng.normal(size=(60,))
    y2, r2 = rng.normal(size=(60, 3)), rng.normal(size=(60, 3))
    d = [rng.normal(size=(60,)) for _ in range(3)]
    cases = [
        ("openloop_rmse", (y, r), {}),
        ("rmse", (y2, r2), {}),
        ("tracking_mse", (y, r), {}),
        ("tracking_mse", (y2, r2), {}),
        ("steady_state_error", (y, r), {"tail": 7}),
        ("steady_state_error", (y2, r2), {}),
    ]
    for name, args, kw in cases:
        got = float(getattr(tmetrics, name)(*(torch.tensor(a) for a in args),
                                            **kw))
        want = float(getattr(jmetrics, name)(*(jnp.asarray(a) for a in args),
                                             **kw))
        assert got == pytest.approx(want, rel=1e-12, abs=0), name
    got = tmetrics.mean_update_norms(*(torch.tensor(a) for a in d))
    want = jmetrics.mean_update_norms(*(jnp.asarray(a) for a in d))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-12, abs=0)


@pytest.mark.parametrize("reencode_every", [0, 7])
def test_openloop_validate_matches_jax(pipes, reencode_every):
    """The free run of the batch-EDMD model under recorded inputs, with and
    without re-encoding from the true state every 7 steps: predictions,
    lifted trajectory and both RMSEs to 1e-10 relative to their scale."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, size=(50, 2))
    u = rng.uniform(-2, 2, size=(50, 1))
    j = j_openloop(jpipe.model0, jpipe.dictionary, jnp.asarray(x),
                   jnp.asarray(u), reencode_every=reencode_every)
    t = openloop_validate(pipe.model0, pipe.dictionary, torch.tensor(x),
                          torch.tensor(u), reencode_every=reencode_every)
    for got, want in zip(t, j):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * scale)


def test_spectrum_summary_matches_jax(pipes):
    """The spectrum summary of the same model (numpy float64 on both
    sides): equal, eigenvalue moduli to 1e-12; the modal reconstruction
    equals C A^k z0."""
    jpipe, pipe = pipes
    got = spectrum_summary(pipe.model0, h=0.05)
    want = j_spectrum(jpipe.model0, h=0.05)
    assert got.keys() == want.keys()
    for k in ("controllability_rank", "nlift"):
        assert got[k] == want[k]
    for k in ("spectral_radius", "dominant_frequency_hz"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(sorted(got["eigenvalues_abs"]),
                               sorted(want["eigenvalues_abs"]), rtol=1e-12)
    spec = spectral_decomposition(pipe.model0)
    a, c = (t.numpy() for t in (pipe.model0.A, pipe.model0.C))
    z0 = np.ones(a.shape[0])
    direct = np.stack([c @ np.linalg.matrix_power(a, k) @ z0
                       for k in range(6)])
    np.testing.assert_allclose(reconstruct_prediction(spec, z0, 6), direct,
                               rtol=0, atol=1e-9 * np.abs(direct).max())


def test_archive_run_keys_match_jax(pipes, tmp_path):
    """The port's run archived and the same log archived by the JAX
    package's ``archive_run``: the same ``.npz`` keys with equal arrays,
    and the same ``.mat`` key names with equal arrays."""
    _, pipe = pipes
    _, log = run_single(pipe)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    archive_run(ours, log, h=0.05, mat=True)
    as_numpy = type("Log", (), {k: getattr(log, k).numpy()
                                for k in log._fields})
    j_archive(theirs, as_numpy, h=0.05, mat=True)
    with np.load(ours + ".npz") as a, np.load(theirs + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    ma, mb = sio.loadmat(ours + ".mat"), sio.loadmat(theirs + ".mat")
    keys = lambda m: sorted(k for k in m if not k.startswith("__"))
    assert keys(ma) == keys(mb)
    for k in keys(ma):
        np.testing.assert_array_equal(ma[k], mb[k])


def _assert_logs_equal(got, want, tol=1e-12):
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("preset", ["duffing", "revise2_duffing"])
def test_run_resumable_in_chunks_matches_run_single(preset, tmp_path):
    """45 steps (the switch at 22) in chunks of 15 against one
    uninterrupted ``run_single``: carry and every log series to 1e-12
    (observed: equal); then a run stopped after two chunks and resumed
    from its checkpoint against the uninterrupted one, the same way."""
    cfg = _small(TC, preset, steps=45)
    pipe = build_pipeline(cfg, device="cpu")
    carry, log = run_single(pipe)
    c_carry, c_log = run_resumable(pipe, 45, 15)
    assert c_log.x.shape == log.x.shape
    _assert_logs_equal(c_carry, carry)
    _assert_logs_equal(c_log, log)
    path = str(tmp_path / "ckpt.npz")
    _, first = run_resumable(pipe, 30, 15, checkpoint_path=path)
    r_carry, rest = run_resumable(pipe, 45, 15, checkpoint_path=path,
                                  resume=True)
    assert first.x.shape[0] == 30 and rest.x.shape[0] == 15
    _assert_logs_equal(r_carry, carry)
    for k in ("x", "u", "residual", "drift_a", "lyapunov"):
        whole = getattr(log, k)
        _assert_logs_equal((getattr(first, k), getattr(rest, k)),
                           (whole[:30], whole[30:]))


def test_closed_loop_takes_u0():
    """``u0`` seeds the applied input: in du mode (the tank) a run from a
    nonzero accumulator differs from one from zero, and equals the JAX
    loop's from the same u0 in its first step's input to 1e-9."""
    import dataclasses

    from koopmanx.engine.loop import make_closed_loop as j_make_loop
    from koopmanx.run import _ref_fn as j_ref_fn
    from koopmanx.systems import get_system as j_get_system

    jpipe = j_build_pipeline(_small(JC, "tank", steps=6))
    pipe = pipeline_from_numpy(arrays_from_jax(jpipe), _small(TC, "tank", 6),
                               device="cpu", dtype=F64)
    u0 = np.array([3.0])
    jloop = j_make_loop(j_get_system("tank"), jpipe.dictionary,
                        dataclasses.replace(jpipe.engine_cfg, steps=6),
                        j_ref_fn(jpipe.config, jpipe.dictionary, 1,
                                 jnp.float64))
    _, jlog = jax.jit(jloop)(jpipe.params, jpipe.x_init, jpipe.model0,
                             jpipe.rls0, None, None, jnp.asarray(u0))
    rep = lambda t: type(t)(*(None if v is None else v[None] for v in t))
    _, log = pipe.closed_loop(rep(pipe.params), pipe.x_init[None],
                              rep(pipe.model0), rep(pipe.rls0),
                              u0=torch.tensor(u0)[None])
    _, log0 = pipe.closed_loop(rep(pipe.params), pipe.x_init[None],
                               rep(pipe.model0), rep(pipe.rls0))
    np.testing.assert_allclose(log.u[0].numpy(), np.asarray(jlog.u), rtol=0,
                               atol=1e-9)
    assert not torch.equal(log.u, log0.u)
