"""The port's measuring entry points against the JAX package's:
``koopmanx_torch.bench`` against ``bench.py`` (its config for every preset,
its workload against JAX ``run_batch`` in float64, its JSON line on the
CPU, its refusal to run on the CPU unasked), and
``tools/bench_serving_torch.py`` and ``tools/validate_scale_torch.py``
against ``tools/bench_serving.py`` and ``tools/validate_scale.py``."""
import dataclasses
import json
import math
import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.engine.loop import run_batch as j_run_batch  # noqa: E402
from koopmanx.engine.scenario import sample_scenarios as j_sample  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.systems import get_system as j_get_system  # noqa: E402

from koopmanx_torch import bench  # noqa: E402
from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.engine.scenario import ScenarioBatch  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402
from koopmanx_torch.systems.library import DuffingParams  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_serving_torch  # noqa: E402
import validate_scale_torch  # noqa: E402

# the JAX-only fields, which the port keeps inert (configs.py:69, :117-118)
INERT = {"unroll", "matmul_precision", "qp_unroll"}

# the bench configs of koopmanx_torch/configs.py:514-626, by preset
BENCH_CONFIGS = {
    "duffing": TC.flagship_config,
    "tank": TC.tank_bench_config,
    "duffing_rbf128": TC.rbf128_bench_config,
    "tank_mimo": TC.tank_mimo_bench_config,
    "vanderpol": TC.vdp_bench_config,
    "vanderpol_rbf": TC.vdp_rbf_bench_config,
    "revise2_duffing": TC.revise2_duffing_bench_config,
    "revise2_vdp": TC.revise2_vdp_bench_config,
    "toy1d": TC.toy1d_bench_config,
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_bench_config(env):
    """``bench.py:47-101``, the lines of its ``main()`` that build the
    config, applied to ``env`` in place of ``os.environ``."""
    get = env.get
    steps = int(get("BENCH_STEPS", "200"))
    horizon = int(get("BENCH_HORIZON", "20"))
    preset = get("BENCH_PRESET", "duffing")
    cfg = JC.PRESETS[preset]()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.unroll = int(get("BENCH_UNROLL", "8"))
    cfg.mpc.qp_unroll = int(get("BENCH_QP_UNROLL", "10"))
    cfg.mpc.qp_iters = int(get("BENCH_QP_ITERS", str(cfg.mpc.qp_iters)))
    cfg.mpc.qp_backend = get("BENCH_QP_BACKEND", "xla")
    cfg.mpc.qp_kkt_bf16 = bool(int(get("BENCH_KKT_BF16", "0")))
    cfg.mpc.qp_kkt_refine = int(get("BENCH_KKT_REFINE", "0"))
    cfg.mpc.qp_kkt_block = int(get("BENCH_KKT_BLOCK",
                                   str(cfg.mpc.qp_kkt_block)))
    if get("BENCH_KKT_LOWRANK"):
        cfg.mpc.qp_kkt_lowrank = bool(int(env["BENCH_KKT_LOWRANK"]))
    if get("BENCH_APPLIED_BOUNDS"):
        cfg.mpc.applied_bounds = env["BENCH_APPLIED_BOUNDS"]
    cfg.mpc.qp_kkt_reanchor = int(get("BENCH_KKT_REANCHOR", "16"))
    if get("BENCH_PRECISION"):
        cfg.matmul_precision = get("BENCH_PRECISION")
    if get("BENCH_W_FILTER"):
        cfg.update.window_filter = int(env["BENCH_W_FILTER"])
    if get("BENCH_W_REFIT_EVERY"):
        cfg.update.window_refit_every = int(env["BENCH_W_REFIT_EVERY"])
    if get("BENCH_W_FILTER_LATE"):
        cfg.update.window_filter_late = int(env["BENCH_W_FILTER_LATE"])
    if get("BENCH_W_FILTER_WARMUP"):
        cfg.update.window_filter_warmup = int(env["BENCH_W_FILTER_WARMUP"])
    if get("BENCH_W_CARRY"):
        cfg.update.window_carry = env["BENCH_W_CARRY"]
    if get("BENCH_RIDGE"):
        cfg.update.ridge = float(env["BENCH_RIDGE"])
    if get("BENCH_W_POLISH"):
        cfg.update.window_polish = int(env["BENCH_W_POLISH"])
    if get("BENCH_W_ANCHOR"):
        cfg.update.window_anchor = int(env["BENCH_W_ANCHOR"])
    if get("BENCH_W_STORE"):
        cfg.update.window_store = env["BENCH_W_STORE"]
    cfg.mpc.horizon = horizon
    cfg.switch_step = steps // 2
    if preset == "duffing":
        cfg.data = JC.DataConfig(n_step=50, n_traj=50)
        cfg.lift = JC.LiftConfig(kind="mlp", nlift=8)
    else:
        cfg.data = dataclasses.replace(cfg.data, n_step=50, n_traj=50)
    return cfg


def shared_fields(a, b, skip=frozenset()):
    """The fields that the two configs share, recursively, as
    ``{dotted name: (a's value, b's value)}``, less ``skip``."""
    out = {}
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)

    def walk(x, y, prefix):
        for k in x.keys() & y.keys():
            if k in skip:
                continue
            if isinstance(x[k], dict) and isinstance(y[k], dict):
                walk(x[k], y[k], f"{prefix}{k}.")
            else:
                out[prefix + k] = (x[k], y[k])

    walk(da, db, "")
    return out


def assert_same(a, b, skip=frozenset()):
    """Equal on every shared field; a weights path, which each package
    names in its own way, the same file below the tree it is named in."""
    pairs = shared_fields(a, b, skip)
    assert len(pairs) > 50
    paths = pairs.pop("lift.weights_path")
    if paths[0] != paths[1]:
        # the JAX package joins a reference path to the reference tree and
        # an in-repo one to the repo root; the port keeps them relative
        ours, theirs = (os.path.normpath(p) for p in paths)
        assert theirs.endswith(os.sep + ours), paths
    differ = {k: v for k, v in pairs.items() if v[0] != v[1]}
    assert not differ, differ


@pytest.mark.parametrize("name", sorted(TC.PRESETS))
def test_bench_config_equals_the_jax_bench(name):
    """Every preset: the port's bench config equals bench.py's on every
    field the two RunConfigs share, but for the route, whose default is
    the port's main path (the kernel) where bench.py's is its plain route;
    with the route named the two agree on it too. The nine presets with a
    hand-written bench config (configs.py:514-626) also equal it at 200
    steps, but for the JAX-only fields, which the bench sets as bench.py
    does and the hand-written configs leave at their defaults."""
    env = {"BENCH_PRESET": name}
    ours, theirs = bench.bench_config(env), jax_bench_config(env)
    assert (ours.mpc.qp_backend, theirs.mpc.qp_backend) == ("pallas", "xla")
    assert_same(ours, theirs, skip={"qp_backend"})
    env["BENCH_QP_BACKEND"] = "xla"
    assert_same(bench.bench_config(env), jax_bench_config(env))
    if name in BENCH_CONFIGS:
        assert_same(bench.bench_config({"BENCH_PRESET": name}),
                    BENCH_CONFIGS[name](steps=200), skip=INERT)


@pytest.mark.parametrize("env", [
    {"BENCH_PRESET": "tank", "BENCH_W_FILTER": "12",
     "BENCH_W_REFIT_EVERY": "4", "BENCH_W_FILTER_LATE": "6",
     "BENCH_W_FILTER_WARMUP": "100", "BENCH_W_CARRY": "woodbury",
     "BENCH_RIDGE": "1e-4", "BENCH_W_POLISH": "2", "BENCH_W_ANCHOR": "32",
     "BENCH_W_STORE": "bfloat16", "BENCH_QP_BACKEND": "pallas"},
    {"BENCH_KKT_BF16": "1", "BENCH_KKT_REFINE": "2",
     "BENCH_KKT_REANCHOR": "8", "BENCH_QP_ITERS": "30",
     "BENCH_KKT_BLOCK": "2", "BENCH_KKT_LOWRANK": "0",
     "BENCH_APPLIED_BOUNDS": "rows", "BENCH_UNROLL": "4",
     "BENCH_QP_UNROLL": "5", "BENCH_PRECISION": "highest",
     "BENCH_HORIZON": "10", "BENCH_STEPS": "60", "BENCH_QP_BACKEND": "xla"},
    {"BENCH_DEVICE": "cpu", "BENCH_PRESET": "vanderpol"},
], ids=["window_knobs", "qp_knobs", "cpu_route"])
def test_bench_knobs_equal_the_jax_bench(env):
    """Each of bench.py's knobs sets the same field to the same value; on
    the CPU the route is the plain one, bench.py's default."""
    assert_same(bench.bench_config(env), jax_bench_config(env))


def _arrays_from_jax(pipe):
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    p = pipe.params
    return {
        "mlp": [tuple(layer) for layer in n(pipe.dictionary.params)],
        "normalizer": None,
        "model0": tuple(n(pipe.model0)),
        "rls0": n(pipe.rls0._asdict()),
        "params": {"q_block": n(p.q_block), "r_block": n(p.r_block),
                   "u_min": n(p.u_min), "u_max": n(p.u_max), "cy": None,
                   "ref_state": n(p.ref_state)},
        "x_init": n(pipe.x_init),
    }


def test_bench_workload_matches_jax_run_batch():
    """The bench's flagship workload at 8 scenarios and 12 steps in
    float64: JAX's pipeline and scenarios (bench.py:95-109) carried across
    as numpy arrays, the bench's timed runner against JAX ``run_batch`` on
    the kernel route (both packages take the kernel's plain version on
    the CPU), x and u to 1e-9 (tests/test_torch_loop.py:114-146). The
    JAX scans run un-unrolled (``BENCH_UNROLL``, ``BENCH_QP_UNROLL``: the
    JAX-only knobs, semantics-neutral), which cuts JAX's compile ~3x."""
    batch, steps = 8, 12
    env = {"BENCH_BATCH": str(batch), "BENCH_STEPS": str(steps),
           "BENCH_QP_BACKEND": "pallas", "BENCH_UNROLL": "1",
           "BENCH_QP_UNROLL": "1"}
    jcfg = jax_bench_config(env)
    jcfg.dtype = "float64"
    jpipe = j_build_pipeline(jcfg)
    jsc = j_sample(j_get_system("duffing"), jax.random.PRNGKey(0),
                   batch=batch, x0_range=(-2.0, 2.0), param_scale=0.15,
                   dtype=jnp.float64)
    rep = lambda v: jnp.broadcast_to(v, (batch,) + v.shape)
    tile = lambda tree: jax.tree_util.tree_map(rep, tree)
    _, jlog = j_run_batch(jpipe.closed_loop, tile(jpipe.params), jsc.x0,
                          tile(jpipe.model0), tile(jpipe.rls0), jsc.theta0,
                          jsc.theta1)

    cfg = bench.bench_config(env)
    cfg.dtype = "float64"
    pipe = pipeline_from_numpy(_arrays_from_jax(jpipe), cfg, device="cpu",
                               dtype=torch.float64)
    theta = lambda th: DuffingParams(*(torch.tensor(np.asarray(v))
                                       for v in th))
    sc = ScenarioBatch(x0=torch.tensor(np.asarray(jsc.x0)),
                       theta0=theta(jsc.theta0), theta1=theta(jsc.theta1))
    launches = box_admm.launches
    wall, log = bench.time_runs(pipe, sc, 1)
    assert box_admm.launches == launches  # CPU tensors: no kernel launch
    assert wall > 0
    assert tuple(log.x.shape) == (batch, steps, 2)
    np.testing.assert_allclose(log.x.numpy(), np.asarray(jlog.x), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(log.u.numpy(), np.asarray(jlog.u), rtol=0,
                               atol=1e-9)


def _bench_env(monkeypatch, **env):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_main_on_the_cpu(monkeypatch, capsys):
    """``main()`` with ``BENCH_DEVICE=cpu``: one JSON line of bench.py's
    shape (``bench.py:146-160``) without ``vs_baseline``; solves/s from
    the batch, steps and best wall; the plain route, no launch; finite
    quality."""
    _bench_env(monkeypatch, BENCH_DEVICE="cpu", BENCH_BATCH="8",
               BENCH_STEPS="4", BENCH_REPS="1")
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[-1])
    d = out["detail"]
    assert set(out) == {"metric", "value", "unit", "detail"}
    assert out["unit"] == "solves/s"
    assert "duffing" in out["metric"] and "N=20" in out["metric"]
    assert "batch=8" in out["metric"]
    assert (d["batch"], d["steps"], d["reps"]) == (8, 4, 1)
    assert out["value"] == round(8 * 4 / d["wall_s"], 1)
    assert d["per_step_latency_ms"] == pytest.approx(d["wall_s"] / 4 * 1e3)
    assert d["realtime_budget_ms"] == 50.0
    assert d["qp_backend"] == "xla" and d["box_admm_launches"] == 0
    assert d["device"] == "cpu" and d["card"] is None and d["host_cpu"]
    assert d["ignored_jax_knobs"] == {"BENCH_UNROLL": "8",
                                      "BENCH_QP_UNROLL": "10",
                                      "BENCH_PRECISION": None}
    assert math.isfinite(d["tracking_mse"])
    assert math.isfinite(d["steady_state_error"])


def test_bench_without_cpu_needs_a_card():
    """Without ``BENCH_DEVICE=cpu`` the bench runs on the card; with none
    it raises and does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench({"BENCH_BATCH": "8", "BENCH_STEPS": "4"})


def test_refine_on_the_kernel_route_raises():
    """``BENCH_KKT_REFINE > 0`` with the kernel route raises the engine's
    ``ValueError``, as the JAX package does; the bench does not catch
    it."""
    with pytest.raises(ValueError):
        bench.run_bench({"BENCH_DEVICE": "cpu", "BENCH_QP_BACKEND": "pallas",
                         "BENCH_KKT_REFINE": "2", "BENCH_BATCH": "2",
                         "BENCH_STEPS": "2"})


# tools/bench_serving.py's keys: the single-plant line (:186-193), a
# fleet's (:210-217) and a curve row (:116-119), hlo_ops replaced
SERVING_KEYS = {
    "single": {"metric", "best_ms", "mean_ms", "dispatch_baseline_ms",
               "est_device_ms", "device"},
    "fleet": {"metric", "best_ms", "mean_ms", "per_plant_us",
              "solves_per_s", "device"},
    "curve": {"variant", "device_ops", "best_ms", "mean_ms"},
}


@pytest.mark.parametrize("argv", [
    ["--cpu", "--batches", "1,4", "--reps", "2"],
    ["--cpu", "--curve", "--reps", "1"],
], ids=["fleet", "curve"])
def test_bench_serving_torch_on_the_cpu(argv, capsys):
    """``tools/bench_serving_torch.py --cpu``: the JAX tool's lines with
    its keys, finite times, no kernel launch; the curve's seven variants
    with ``device_ops`` null (no device events on the CPU)."""
    rows = bench_serving_torch.main(argv)
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == json.loads(json.dumps(rows))
    if "--curve" in argv:
        curve = rows[-1]["curve"]
        assert [r["variant"] for r in curve] == [
            "full", "no_update", "admm20", "admm5", "horizon10", "lean",
            "tiny_identity"]
        for r in curve:
            assert SERVING_KEYS["curve"] <= set(r) and r["device_ops"] is None
            assert 0 < r["best_ms"] <= r["mean_ms"]
        assert rows[-1]["device"] == "cpu"
        return
    single, fleet = rows
    assert SERVING_KEYS["single"] <= set(single)
    assert SERVING_KEYS["fleet"] <= set(fleet)
    assert "fleet=4" in fleet["metric"]
    for r in rows:
        assert r["device"] == "cpu" and r["calls"] == 2
        assert r["box_admm_launches"] == 0
        assert 0 < r["best_ms"] <= r["p50_ms"]
    assert fleet["solves_per_s"] == pytest.approx(
        4 / (fleet["best_ms"] / 1e3))


def test_validate_scale_torch_has_the_jax_tools_keys(monkeypatch, capsys):
    """``tools/validate_scale_torch.py`` at ``PRESET=toy1d STEPS=20 CPU=1``
    prints the key set of ``tools/validate_scale.py`` run at the same size
    on the CPU, plus the launches, the route, the card and the ignored
    knob; finite values, |u| within toy1d's box of 1."""
    for k, v in {"PRESET": "toy1d", "STEPS": "20", "CPU": "1"}.items():
        monkeypatch.setenv(k, v)
    runpy.run_path(os.path.join(ROOT, "tools", "validate_scale.py"),
                   run_name="__main__")
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = validate_scale_torch.main()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(ours))
    extra = {"qp_backend", "box_admm_launches", "card", "ignored_jax_knobs"}
    assert set(ours) - extra == set(theirs)
    assert ours["preset"] == "toy1d" and ours["steps"] == 20
    assert ours["device"] == "cpu" and ours["qp_backend"] == "xla"
    assert ours["finite"] and ours["box_admm_launches"] == 0
    assert ours["u_abs_max"] <= 1.0
    for k, v in ours.items():
        if isinstance(v, float):
            assert math.isfinite(v), k
