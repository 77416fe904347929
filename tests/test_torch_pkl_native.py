"""koopmanx_torch's torch-checkpoint importer (``lifts/io.py``:
``load_torch_state_dict``, ``load_torch_autoencoder``; the ``.pkl`` lift
of ``run.build_dictionary`` and ``convert.pipeline_from_numpy``), the
autoencoder lift (``lifts/mlp.py``), the native C++ plant and box-QP
solver (``ops/native.py``, ``systems/native.py``) and the
hardware-in-the-loop tool (``tools/bench_hil_torch.py``), against the
JAX package's counterparts and the port's own integrators. float64 on
the CPU unless named; inputs from numpy with a seed."""
import json
import os
import pickle
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from koopmanx.lifts import io as jio  # noqa: E402
from koopmanx.lifts import mlp as jmlp  # noqa: E402
from koopmanx.ops import native as jnative_ops  # noqa: E402
from koopmanx.systems import get_system as j_get_system  # noqa: E402
from koopmanx.systems import native as jnative  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy, pipeline_to_numpy  # noqa: E402
from koopmanx_torch.lifts import io as tio  # noqa: E402
from koopmanx_torch.lifts import mlp as tmlp  # noqa: E402
from koopmanx_torch.ops import native as tnative_ops  # noqa: E402
from koopmanx_torch.run import build_pipeline, run_single  # noqa: E402
from koopmanx_torch.systems import native as tnative  # noqa: E402
from koopmanx_torch.systems.base import as_params, make_step  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_hil_torch  # noqa: E402

F64 = torch.float64


class AutoEncoder(nn.Module):
    """The reference's checkpoint layout (``duffing.py:21-38``): ReLU
    ``nn.Sequential`` encoder and decoder, pickled whole by
    ``torch.save(model)``."""

    def __init__(self, n=2, nlift=8, hidden=100):
        super().__init__()
        enc, dec = tmlp.reference_autoencoder_sizes(n, nlift, hidden)
        self.Encoder, self.Decoder = (nn.Sequential(*[
            layer for a, b in zip(s[:-1], s[1:])
            for layer in (nn.Linear(a, b), nn.ReLU())][:-1])
            for s in (enc, dec))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A reference-layout autoencoder (2-100-100-100-8 and back, seed 0),
    saved whole and as its state_dict."""
    torch.manual_seed(0)
    model = AutoEncoder()
    d = tmp_path_factory.mktemp("pkl")
    paths = {"model": str(d / "AutoEncoder_duffing.pkl"),
             "state_dict": str(d / "state_dict.pkl")}
    torch.save(model, paths["model"])
    torch.save(model.state_dict(), paths["state_dict"])
    return model, paths


@pytest.mark.parametrize("kind", ["model", "state_dict"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_checkpoint_loads_as_jax_loads_it(checkpoints, kind, dtype):
    """``torch.save(model)`` and ``torch.save(model.state_dict())`` of
    this torch: the port's loader gives JAX's ``load_torch_autoencoder``
    arrays bit for bit (four encoder and four decoder layers, (out, in)),
    and its state dict is the module's own."""
    model, paths = checkpoints
    enc, dec = tio.load_torch_autoencoder(paths[kind], getattr(torch, dtype))
    jenc, jdec = jio.load_torch_autoencoder(paths[kind], getattr(jnp, dtype))
    assert [tuple(w.shape) for w, _ in enc] == [(100, 2), (100, 100),
                                                 (100, 100), (8, 100)]
    assert len(dec) == 4 and tuple(dec[-1][0].shape) == (2, 100)
    for (w, b), (jw, jb) in zip(enc + dec, jenc + jdec, strict=True):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    state = tio.load_torch_state_dict(paths[kind])
    own = model.state_dict()
    assert sorted(state) == sorted(own)
    for k, v in own.items():
        np.testing.assert_array_equal(state[k], v.numpy())


def test_autoencoder_dictionary_decodes_as_jax():
    """``autoencoder_dictionary`` of the reference's sizes: encode and
    decode against JAX's on the same weights within 1e-12."""
    rng = np.random.default_rng(1)
    enc_s, dec_s = tmlp.reference_autoencoder_sizes(2, 6, 16)
    assert (enc_s, dec_s) == jmlp.reference_autoencoder_sizes(2, 6, 16)
    layers = lambda sizes: [(rng.normal(size=(b, a)) / np.sqrt(a),
                             rng.normal(size=b)) for a, b in
                            zip(sizes[:-1], sizes[1:])]
    enc, dec = layers(enc_s), layers(dec_s)
    td = tmlp.autoencoder_dictionary(
        *(tmlp.MLP.from_params([(torch.tensor(w), torch.tensor(b))
                                for w, b in p]) for p in (enc, dec)), n=2)
    jd = jmlp.autoencoder_dictionary(
        *([(jnp.asarray(w), jnp.asarray(b)) for w, b in p]
          for p in (enc, dec)), n=2)
    assert td.has_decoder and td.nlift == jd.nlift == 6
    x = rng.uniform(-2, 2, (32, 2))
    z = rng.normal(size=(32, 6))
    with torch.no_grad():
        np.testing.assert_allclose(td(torch.tensor(x)).numpy(),
                                   np.asarray(jd(jnp.asarray(x))), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(td.decode(torch.tensor(z)).numpy(),
                                   np.asarray(jd.decode(jnp.asarray(z))),
                                   rtol=0, atol=1e-12)


def _small_duffing(weights):
    cfg = TC.PRESETS["duffing"]()
    cfg.steps, cfg.dtype = 8, "float64"
    cfg.data = TC.DataConfig(n_step=20, n_traj=20)
    cfg.lift.weights_path = weights
    return cfg


def test_pkl_pipeline_equals_mat_pipeline(checkpoints, tmp_path):
    """The shipped ``duffing`` preset with the checkpoint's encoder as its
    ``.pkl`` weights equals the same preset with those weights exported
    by ``save_mat_mlp`` as ``.mat``, bit for bit: every pipeline leaf and
    an 8-step ``run_single``. ``convert.pipeline_from_numpy`` takes the
    ``.pkl`` path for its MLP and gives the same pipeline."""
    model, paths = checkpoints
    enc, _ = tio.load_torch_autoencoder(paths["model"])
    mat = str(tmp_path / "encoder.mat")
    tio.save_mat_mlp(mat, enc)
    pipes = [build_pipeline(_small_duffing(w), device="cpu")
             for w in (paths["model"], mat)]
    runs = [run_single(p) for p in pipes]
    with torch.no_grad():
        z = [p.dictionary(p.x_init) for p in pipes]
    leaves = [tree_leaves((p.model0, p.rls0, p.params, r, zz))
              for p, r, zz in zip(pipes, runs, z)]
    for a, b in zip(*leaves, strict=True):
        assert torch.equal(a, b)
    arrays = pipeline_to_numpy(pipes[1])
    arrays["mlp"] = paths["model"]
    pipe = pipeline_from_numpy(arrays, _small_duffing(mat), device="cpu",
                               dtype=F64)
    with torch.no_grad():
        assert torch.equal(pipe.dictionary(pipes[1].x_init), z[1])


class _Writes:
    """A class that writes a file when it is built or unpickled."""

    def __init__(self, path):
        self.path = path
        open(path, "w").close()

    def __reduce__(self):
        return (_Writes, (self.path,))

    def __setstate__(self, state):
        open(state["path"], "w").close()


class _System:
    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return (os.system, (self.cmd,))


def _checkpoint_of(obj, path):
    """A zip checkpoint whose ``data.pkl`` is the pickle of ``obj``."""
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps(obj, protocol=2))


def test_crafted_checkpoints_run_nothing(tmp_path):
    """A checkpoint whose pickle REDUCEs ``os.system`` (a shell command
    that would create a file), or builds a class that writes a file when
    built, loads as no tensors and runs nothing: no file appears. (The
    second pickle, given to Python's own unpickler, does write its
    file.)"""
    target = tmp_path / "pwned"
    evil = tmp_path / "system.pkl"
    _checkpoint_of(_System(f"touch {target}"), evil)
    writer = tmp_path / "writer.pkl"
    obj = _Writes(str(tmp_path / "seed"))
    obj.path = str(target)
    _checkpoint_of({"m": obj}, writer)
    for path in (evil, writer):
        state = tio.load_torch_state_dict(str(path))
        assert all(v.dtype == object for v in state.values())
        assert not target.exists()
    with zipfile.ZipFile(writer) as zf:
        pickle.loads(zf.read("archive/data.pkl"))
    assert target.exists()


# ---- the native plant ----

@pytest.mark.parametrize("name", sorted(tnative._SYS))
def test_native_plant_matches_jax_and_the_port(name):
    """Every plant of the native library, both integrators: the port's
    ``native_step_batch`` (64 random states, shared and per-plant
    parameters), ``native_step`` and ``native_rollout`` (20 steps) against
    JAX's bindings bit for bit, and against the port's own
    ``systems.base.make_step`` within 1e-12 of max(1, |x|)."""
    system, jsystem = get_system(name), j_get_system(name)
    assert tnative.supported(system) and jnative.supported(jsystem)
    rng = np.random.default_rng(sorted(tnative._SYS).index(name))
    for integ in ("rk4", "rk4_matlab"):
        x = rng.uniform(0.1, 2.0, (64, system.n))
        u = rng.uniform(-1.0, 1.0, (64, system.m))
        theta = system.theta0
        per = type(theta)(*(np.full(64, v) * rng.uniform(0.9, 1.1, 64)
                            for v in theta))
        got = tnative.native_step_batch(system, x, u, theta, 0.05, integ)
        np.testing.assert_array_equal(got, jnative.native_step_batch(
            jsystem, x, u, jsystem.theta0, 0.05, integ))
        per_got = tnative.native_step_batch(system, x, u, per, 0.05, integ,
                                            per_plant_theta=True)
        np.testing.assert_array_equal(per_got, jnative.native_step_batch(
            jsystem, x, u, per, 0.05, integ, per_plant_theta=True))
        step = make_step(system, 0.05, integ)
        for out, th in ((got, as_params(theta, F64, "cpu")),
                        (per_got, as_params(per, F64, "cpu"))):
            ref = step(torch.tensor(x), torch.tensor(u), th).numpy()
            err = np.abs(out - ref) / np.maximum(1, np.abs(ref))
            assert (err <= 1e-12).all(), err.max()
        np.testing.assert_array_equal(
            tnative.native_step(system, x[0], u[0], theta, 0.05, integ),
            got[0])
        useq = rng.uniform(-1.0, 1.0, (20, system.m))
        roll = tnative.native_rollout(system, x[0], useq, theta, 0.05, integ)
        np.testing.assert_array_equal(roll, jnative.native_rollout(
            jsystem, x[0], useq, jsystem.theta0, 0.05, integ))
        xt = torch.tensor(x[:1])
        th = as_params(theta, F64, "cpu")
        for t in range(20):
            xt = step(xt, torch.tensor(useq[t:t + 1]), th)
            assert (np.abs(roll[t] - xt[0].numpy())
                    <= 1e-12 * np.maximum(1, np.abs(roll[t]))).all()


def test_unknown_plant_is_refused():
    fake = get_system("duffing").__class__(name="nope", n=1, m=1)
    assert not tnative.supported(fake)
    with pytest.raises(tnative.NativeUnavailable, match="no native plant"):
        tnative.native_step(fake, [0.0], [0.0], (), 0.05)


def test_native_refuses_misshapen_inputs():
    """The C side reads as many values as the plant's sizes say: a state,
    input or parameter tuple of another size raises before any call."""
    duffing = get_system("duffing")
    th = duffing.theta0
    for call in (
            lambda: tnative.native_step(duffing, [0.0], [0.0], th, 0.05),
            lambda: tnative.native_step(duffing, [0.0, 0.0], [0.0],
                                        th[:2], 0.05),
            lambda: tnative.native_step_batch(duffing, np.zeros((4, 2)),
                                              np.zeros((3, 1)), th, 0.05),
            lambda: tnative.native_step_batch(
                duffing, np.zeros((4, 2)), np.zeros((4, 1)),
                tuple(np.zeros(3) for _ in th), 0.05, per_plant_theta=True),
            lambda: tnative.native_rollout(duffing, [0.0], np.zeros(5), th,
                                           0.05),
            lambda: tnative_ops.boxqp_solve(np.eye(3), np.zeros(2), -1, 1)):
        with pytest.raises(ValueError):
            call()


def test_boxqp_matches_jax():
    """The exact box-QP solver, one problem and a batch of 16, against
    JAX's binding of the same C++ bit for bit."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(16, 10, 10))
    p = a @ np.swapaxes(a, -1, -2) + 10 * np.eye(10)
    q = rng.normal(size=(16, 10))
    got = tnative_ops.boxqp_solve(p, q, -0.5, 0.5)
    np.testing.assert_array_equal(got, jnative_ops.boxqp_solve(p, q, -0.5, 0.5))
    np.testing.assert_array_equal(
        tnative_ops.boxqp_solve(torch.tensor(p[0]), torch.tensor(q[0]),
                                -0.5, 0.5), got[0])
    assert (np.abs(got) <= 0.5 + 1e-12).all()


def test_native_library_builds_into_the_port():
    """The port builds its own library into ``koopmanx_torch/_build/`` from
    ``csrc/``'s sources and writes nothing into ``csrc/``."""
    csrc = os.path.join(ROOT, "csrc")
    before = {f: os.stat(os.path.join(csrc, f)).st_mtime_ns
              for f in os.listdir(csrc)}
    assert tnative_ops.available()
    assert tnative_ops.LIB_PATH.parent == (
        tnative_ops.PKG_DIR / "_build")
    assert tnative_ops.LIB_PATH.exists()
    assert {f: os.stat(os.path.join(csrc, f)).st_mtime_ns
            for f in os.listdir(csrc)} == before


@pytest.mark.parametrize("argv", [
    ["--preset", "pendulum", "--steps", "60", "--cpu"],
    ["--preset", "tank", "--fleet", "4", "--steps", "60", "--cpu"],
], ids=["single", "fleet"])
def test_bench_hil_torch_runs_on_the_cpu(argv, capsys):
    """``tools/bench_hil_torch.py --cpu``: one JSON line with the period's
    latency percentiles, the plant's share and the tracking record; the
    loop tracks (finite, the output's tail closer to the target than the
    start)."""
    out = bench_hil_torch.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert out["steps"] == 60 and out["device"] == "cpu"
    assert 0 < out["plant_share"] < 1
    assert out["latency_ms"]["p50"] <= out["period_ms"]["p50"]
    tr = out["tracking"]
    assert tr["finite"]
    cfg = TC.PRESETS[argv[1]]()
    start = abs(float(get_system(cfg.system).x_init) - tr["target"])
    err = tr.get("steady_state_error", tr.get("worst_plant_steady_state_error"))
    assert err < start

