"""The port's last user tools against the JAX package's:
``tools/train_reference_scale_torch.py`` (and the cosine schedule it trains
under, ``train/kmae.py::cosine_adam``), ``tools/eval_encoder_both_metrics_
torch.py``, ``tools/bench_terminal_torch.py`` and ``tools/bench_multihost_
torch.py`` against their ``tools/`` counterparts, on numpy inputs made
from a seed or on the JAX package's own draws carried across.

Sizes are small (a 2-8-8-8-4 autoencoder, 10 x 12 snapshots; 40 closed-loop
steps; 4 scenarios); each tool's ``main`` runs at a tiny size on the CPU
and prints the JAX tool's keys, compared with a literal list taken from
the JAX tool's source. Nothing is written outside pytest's temporary
directories."""
import ast
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from koopmanx import configs as JC  # noqa: E402
from koopmanx.run import build_pipeline as j_build_pipeline  # noqa: E402
from koopmanx.run import run_single as j_run_single  # noqa: E402
from koopmanx.systems import collect as j_collect  # noqa: E402
from koopmanx.systems import get_system as j_get_system  # noqa: E402
from koopmanx.train import kmae as jk  # noqa: E402

from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.convert import pipeline_from_numpy  # noqa: E402
from koopmanx_torch.run import run_single  # noqa: E402
from koopmanx_torch.systems.data import Snapshots  # noqa: E402
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.train import kmae as tk  # noqa: E402
from koopmanx_torch.train import state as tstate  # noqa: E402
from koopmanx_torch.train import trainer as tt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)
import bench_multihost_torch  # noqa: E402
import bench_terminal_torch  # noqa: E402
import eval_encoder_both_metrics_torch as eval_tool  # noqa: E402
import train_reference_scale_torch as train_tool  # noqa: E402

import eval_encoder_both_metrics as j_eval_tool  # noqa: E402

F64 = torch.float64
ARTIFACT = os.path.join(ROOT, "artifacts", "duffing_kmae_encoder.mat")

# the JSON keys of each JAX tool, from its source
TRAIN_KEYS = {  # tools/train_reference_scale.py:194-217
    "system", "tag", "snapshots", "epochs", "seed", "lr", "cosine_final",
    "rec_only_after", "val_select", "pred_horizon", "steps_per_epoch",
    "train_wall_s", "device", "final_epoch", "fresh_losses",
    "openloop_rmse_500", "artifact"}
EVAL_KEYS = {  # tools/eval_encoder_both_metrics.py:128-134
    "artifact", "open_rmse", "closed_sse", "u_abs_max", "finite"}
TERMINAL_KEYS = {  # tools/bench_terminal.py:80-86
    "workload", "lapack", "batch", "solves_per_s", "per_step_ms"}
MULTIHOST_KEYS = {  # tools/bench_multihost.py:199-209
    "procs", "devices_global", "batch_global", "steps", "wall_s",
    "rep_walls", "solves_per_s", "gram_psum_us", "finite"}
CORUN_KEYS = {  # tools/bench_multihost.py:322-331
    "procs", "independent", "batch_global", "steps", "wall_s",
    "rep_walls_global", "solves_per_s", "finite"}
MULTIHOST_TOP_KEYS = {  # tools/bench_multihost.py:356-395
    "single_process", "independent_corun", "multi_process",
    "weak_scaling_efficiency", "hardware_contention_efficiency",
    "process_boundary_efficiency", "cores_pinned_per_rank", "caveat"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _tree(params):
    return [tuple(np.asarray(t) for t in layer) for layer in params]


# ---- the cosine schedule ----------------------------------------------------

N_TRAJ, N_STEP, H, NLIFT, HIDDEN, BATCH = 10, 12, 3, 4, 8, 16
LR, DECAY_STEPS, ALPHA, K_STEPS = 1e-2, 3, 0.1, 6


@pytest.mark.parametrize("t", range(8))
def test_cosine_decay_is_optax_at_every_update(t):
    """The rate at update t (from 0) of ``cosine_adam``'s schedule, as its
    optimizer holds it before that update, equals optax's schedule at t
    bit for bit, t past decay_steps too; the first update uses the
    initial rate."""
    want = float(optax.cosine_decay_schedule(LR, DECAY_STEPS, ALPHA)(t))
    p = [torch.zeros(2, dtype=F64, requires_grad=True)]
    opt, schedule = tk.cosine_adam(LR, DECAY_STEPS, ALPHA)(p)
    for _ in range(t):
        p[0].grad = torch.ones(2, dtype=F64)
        opt.step()
        schedule.step()
    assert opt.param_groups[0]["lr"] == want
    assert LR * tk.cosine_decay(DECAY_STEPS, ALPHA)(t) == want
    with pytest.raises(ValueError, match="positive"):
        tk.cosine_decay(0)


def test_cosine_schedule_train_steps_match_jax_f64():
    """K_STEPS > DECAY_STEPS port steps under ``cosine_adam`` against
    ``optax.adam(optax.cosine_decay_schedule(...))`` through JAX's
    ``make_train_step``, in float64, from one JAX state carried across, on
    the same minibatches (the full loss; the rec-only branch steps the
    same optimizer, and test_torch_train.py holds it): every parameter,
    Adam's moments, A, B and the losses within 1e-10 relative, the counts
    and the rate equal."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (N_TRAJ * N_STEP, 2))
    y = x + 0.05 * rng.normal(size=x.shape)
    u = rng.uniform(-2, 2, (N_TRAJ * N_STEP, 1))
    cfg_j = jk.KMAEConfig(pred_horizon=H)
    cfg_t = tk.KMAEConfig(pred_horizon=H)
    opt_j = optax.adam(optax.cosine_decay_schedule(LR, DECAY_STEPS, ALPHA))
    js = jk.init_state(jax.random.PRNGKey(4), cfg_j, n=2, nlift=NLIFT,
                       hidden=HIDDEN, dtype=jnp.float64, optimizer=opt_j)
    jstep = jax.jit(jk.make_train_step(cfg_j, optimizer=opt_j)[0],
                    static_argnums=6)
    factory = tk.cosine_adam(LR, DECAY_STEPS, ALPHA)
    ts = tk.init_state(torch.Generator().manual_seed(0), cfg_t, n=2,
                       nlift=NLIFT, hidden=HIDDEN, dtype=F64,
                       optimizer=factory, device="cpu")
    adam = js.opt_state[0]
    ts = tstate.load_kmae_numpy(ts, {
        "encoder": _tree(js.params.encoder),
        "decoder": _tree(js.params.decoder), "count": int(adam.count),
        "mu": {"encoder": _tree(adam.mu.encoder),
               "decoder": _tree(adam.mu.decoder)},
        "nu": {"encoder": _tree(adam.nu.encoder),
               "decoder": _tree(adam.nu.decoder)},
        "a_prev": np.asarray(js.a_prev), "b_prev": np.asarray(js.b_prev)})
    tstep, _ = tk.make_train_step(cfg_t, factory)
    jxw, juw = jk.make_windows(*(jnp.asarray(a) for a in (x, y, u)), N_STEP,
                               H)
    txw, tuw = tk.make_windows(*(torch.tensor(a) for a in (x, y, u)),
                               N_STEP, H)
    jin = [jnp.asarray(a) for a in (x, y, u)]
    tin = [torch.tensor(a) for a in (x, y, u)]
    for k in range(K_STEPS):
        idx = rng.permutation(jxw.shape[0])[:BATCH]
        js, jl, _ = jstep(js, *jin, jxw[idx], juw[idx], False)
        ts, tl, _ = tstep(ts, *tin, txw[idx], tuw[idx], False)
        assert rel(float(tl), float(jl)) <= 1e-10, k
    assert int(js.opt_state[1].count) == ts.schedule.last_epoch == K_STEPS
    assert ts.opt_state.param_groups[0]["lr"] == float(
        optax.cosine_decay_schedule(LR, DECAY_STEPS, ALPHA)(K_STEPS))
    ours = tstate.kmae_state_to_numpy(ts)
    adam = js.opt_state[0]
    assert ours["count"] == int(adam.count) == K_STEPS
    pairs = [(ours[key], _tree(getattr(js.params, key)))
             for key in ("encoder", "decoder")]
    pairs += [(ours[m][key], _tree(getattr(getattr(adam, m), key)))
              for m in ("mu", "nu") for key in ("encoder", "decoder")]
    for a, b in pairs:
        for (wa, ba), (wb, bb) in zip(a, b):
            assert rel(wa, wb) <= 1e-10 and rel(ba, bb) <= 1e-10
    assert rel(ours["a_prev"], js.a_prev) <= 1e-10
    assert rel(ours["b_prev"], js.b_prev) <= 1e-10


def test_a_schedule_does_not_checkpoint(tmp_path):
    """A scheduled state is refused by ``fit`` with a checkpoint path
    before its first step (the schema has no leaf for the schedule's
    count), and by ``save_checkpoint``."""
    rng = np.random.default_rng(5)
    snaps = Snapshots(*(torch.tensor(a) for a in (
        rng.uniform(-2, 2, (N_TRAJ * N_STEP, 2)),
        rng.uniform(-2, 2, (N_TRAJ * N_STEP, 2)),
        rng.uniform(-2, 2, (N_TRAJ * N_STEP, 1)))))
    cfg = tk.KMAEConfig(pred_horizon=H, epochs=1)
    path = str(tmp_path / "kmae.npz")
    with pytest.raises(ValueError, match="schedule"):
        tt.fit(snaps, N_STEP, cfg, nlift=NLIFT, hidden=HIDDEN, dtype=F64,
               checkpoint_path=path, verbose=False, device="cpu",
               optimizer=tk.cosine_adam(LR, DECAY_STEPS, ALPHA))
    assert not os.path.exists(path)
    state = tk.init_state(torch.Generator().manual_seed(0), cfg, n=2,
                          nlift=NLIFT, hidden=HIDDEN, dtype=F64,
                          optimizer=tk.cosine_adam(LR, 3), device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        tt.save_checkpoint(path, state, 0)


# ---- the training tool -------------------------------------------------------

def test_train_tool_main_on_the_cpu(tmp_path, capsys):
    """``main`` at a tiny size with the cosine schedule and the validation
    selection: one JSON line with the JAX tool's keys, the export in the
    given directory and nowhere else, the held rate the schedule's at the
    held count, the losses finite."""
    before = sorted(os.listdir(os.path.join(ROOT, "artifacts")))
    out = train_tool.main([
        "--cpu", "--epochs", "2", "--n-step", "12", "--n-traj", "10",
        "--batch-windows", "32", "--cosine-final", "0.01", "--val-select",
        "--eval-every", "1", "--out-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert TRAIN_KEYS <= set(out)
    assert out["tag"] == "refscale_torch" and out["card"] is None
    assert sorted(os.listdir(tmp_path)) == [
        "duffing_kmae_refscale_torch_decoder.mat",
        "duffing_kmae_refscale_torch_encoder.mat"]
    assert sorted(os.listdir(os.path.join(ROOT, "artifacts"))) == before
    total = out["epochs"] * out["steps_per_epoch"]
    want = 1e-3 * tk.cosine_decay(total, 0.01)(out["schedule_count"])
    assert out["lr_last"] == want
    assert out["schedule_count"] in (out["steps_per_epoch"], total)
    assert all(math.isfinite(v) for v in out["fresh_losses"].values())
    assert set(out["openloop_rmse_500"]) == {"kmae_refscale_torch",
                                             "preset_dictionary"}


def test_tools_want_a_card_unless_asked_for_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    for call in (lambda: train_tool.main(["--epochs", "1"]),
                 lambda: eval_tool.main([]),
                 lambda: bench_terminal_torch.main({}),
                 lambda: bench_multihost_torch.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---- the two-metric scoring ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_protocol():
    """The JAX tool's protocol snapshots (tools/eval_encoder_both_metrics
    .py:50-51) and its score of the shipped artifact."""
    jsys = j_get_system("duffing")
    data = j_collect(jsys, jax.random.PRNGKey(0), n_step=100, n_traj=100)
    val = j_collect(jsys, jax.random.PRNGKey(2), n_step=500, n_traj=1)
    return data, val, j_eval_tool.openloop_rmse(jsys, ARTIFACT)


def snapshots(s, dtype=None):
    return Snapshots(*(torch.tensor(np.asarray(a, dtype=dtype))
                       for a in (s.x, s.y, s.u)))


def test_openloop_score_matches_jax_f64(jax_protocol):
    """The scoring path (``openloop_rmse_host``: normalizer, pinv fit,
    500-step free run) on the JAX tool's snapshots and the shipped
    artifact, all in float64, against the JAX tool's sequence of calls
    (``fit_normalizer``, ``normalized``, ``edmd_fit(method='pinv')``,
    ``openloop_validate``) in float64: both RMSEs within 1e-10
    relative."""
    from koopmanx.edmd.batch import edmd_fit
    from koopmanx.eval.openloop import openloop_validate
    from koopmanx.lifts.base import fit_normalizer, normalized
    from koopmanx.lifts.io import load_mat_mlp as j_load
    from koopmanx.lifts.mlp import encoder_dictionary as j_encoder
    from koopmanx.systems.data import Snapshots as JSnapshots
    from koopmanx_torch.lifts.io import load_mat_mlp
    from koopmanx_torch.lifts.mlp import MLP, encoder_dictionary

    data, val, _ = jax_protocol
    f64 = lambda s: JSnapshots(*(jnp.asarray(a, jnp.float64) for a in s))
    jd, jv = f64(data), f64(val)
    d = j_encoder(j_load(ARTIFACT, dtype=jnp.float64), n=2)
    mu, sc = fit_normalizer(d, jd.x)
    d = normalized(d, mu, sc)
    res = openloop_validate(edmd_fit(d, jd, method="pinv"), d, jv.x, jv.u,
                            reencode_every=0)
    ours = encoder_dictionary(MLP.from_params(load_mat_mlp(ARTIFACT, F64)),
                              n=2)
    got = train_tool.openloop_rmse_host(ours, snapshots(data, np.float64),
                                        snapshots(val, np.float64))
    for a, b in zip(got, (float(res.rmse_ref), float(res.rmse))):
        assert abs(a - b) <= 1e-10 * b, (got, res)


def test_openloop_score_matches_jax_f32(jax_protocol):
    """The tool's ``open_rmse`` of the shipped artifact (float32, as both
    tools run it) on the JAX tool's snapshots carried across, against the
    JAX tool's ``openloop_rmse``: within 1e-3 relative or ten times the
    port's own spread when the 10,000 snapshot rows are summed in two
    other orders, where that is larger (float32 round-off in the pinv fit,
    carried by the 500-step free run, moves the score by ~3e-3 relative
    in either package)."""
    data, val, want = jax_protocol
    system = get_system("duffing")
    got = eval_tool.openloop_rmse(system, ARTIFACT, snapshots(data),
                                  snapshots(val))
    spread = 0.0
    for k in (1, 2):
        rows = torch.tensor(np.random.default_rng(k).permutation(10000))
        other = eval_tool.openloop_rmse(
            system, ARTIFACT, Snapshots(*(t[rows] for t in snapshots(data))),
            snapshots(val))
        spread = max(spread, abs(other - got))
    assert abs(got - want) <= max(1e-3 * want, 10 * spread), (got, want,
                                                              spread)


def test_closed_sse_matches_jax_run_single_f64():
    """The closed-loop metrics of the duffing artifact over 40 float64
    steps: JAX's pipeline (``tools/eval_encoder_both_metrics.py:62-79``'s
    config) carried across, the port's ``run_single`` against JAX's,
    each metric within 1e-9 of JAX's (the JAX tool's formula)."""
    steps = 40
    jcfg = JC.duffing_nn_preset()
    jcfg.steps, jcfg.dtype = steps, "float64"
    jcfg.lift.weights_path = ARTIFACT
    jcfg.data = dataclasses.replace(jcfg.data, n_step=30, n_traj=30)
    jpipe = j_build_pipeline(jcfg)
    _, jlog = j_run_single(jpipe)
    x, r = np.asarray(jlog.x), np.asarray(jlog.r)
    tail = slice(-max(steps // 10, 20), None)
    want = (abs(x[tail, 0].mean() - r[-1, 0]),
            np.abs(np.asarray(jlog.u)).max(), bool(np.isfinite(x).all()))

    cfg = eval_tool.closed_loop_config("duffing", ARTIFACT, steps, "cpu")
    cfg.dtype = "float64"
    assert cfg.mpc.qp_backend == "xla"
    n = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    inner, mu, sc = n(jpipe.dictionary.params)
    arrays = {
        "mlp": [tuple(layer) for layer in inner], "normalizer": (mu, sc),
        "model0": tuple(n(jpipe.model0)), "rls0": n(jpipe.rls0._asdict()),
        "params": {k: n(v) for k, v in jpipe.params._asdict().items()
                   if v is not None},
        "x_init": n(jpipe.x_init)}
    pipe = pipeline_from_numpy(arrays, cfg, device="cpu", dtype=F64)
    got = eval_tool.closed_metrics(run_single(pipe)[1], steps)
    assert abs(got[0] - want[0]) <= 1e-9 and abs(got[1] - want[1]) <= 1e-9
    assert got[2] is want[2] is True


def test_eval_tool_main_on_the_cpu(capsys):
    """``main`` on the shipped artifact and a missing one at 20 steps: the
    JAX tool's keys (its ``error`` line for the missing one), |u| within
    the preset's box, ``open_rmse`` the same function's value."""
    rows = eval_tool.main(["--cpu", "--steps", "20", "--artifacts",
                           f"{ARTIFACT},{ARTIFACT}.missing"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines == rows and len(rows) == 2
    assert set(rows[0]) == EVAL_KEYS
    assert rows[1] == {"artifact": f"{ARTIFACT}.missing", "error": "missing"}
    assert rows[0]["finite"] and rows[0]["u_abs_max"] <= 2.0
    want = eval_tool.openloop_rmse(get_system("duffing"), ARTIFACT)
    assert rows[0]["open_rmse"] == round(want, 5)
    assert eval_tool.default_artifacts("vanderpol")[-1].endswith(
        "vanderpol_kmae_refscale_encoder.mat")


# ---- the terminal-synthesis bench ----------------------------------------------

def jax_terminal_config(steps):
    """``tools/bench_terminal.py:41-53``, the lines that build its
    config."""
    cfg = JC.duffing_nn_preset()
    cfg.steps = steps
    cfg.dtype = "float32"
    cfg.switch_step = steps // 2
    cfg.data = JC.DataConfig(n_step=50, n_traj=50)
    cfg.lift = JC.LiftConfig(kind="mlp", nlift=8)
    cfg.mpc.terminal_synthesis = True
    cfg.mpc.terminal_mode = "dare"
    return cfg


def flat_fields(tree, prefix=""):
    """A config's fields as ``{dotted name: value}``."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else \
        dataclasses.asdict(tree).items()
    for k, v in items:
        if isinstance(v, dict):
            out.update(flat_fields(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_bench_terminal_config_equals_the_jax_tool():
    """Every field the two RunConfigs share is equal but the route, the
    port's kernel on the card and its plain version on the CPU (the JAX
    tool runs its default plain route)."""
    ours = flat_fields(bench_terminal_torch.config(30, None))
    theirs = flat_fields(jax_terminal_config(30))
    shared = ours.keys() & theirs.keys()
    assert len(shared) > 50
    assert ours.pop("mpc.qp_backend") == "pallas"
    assert theirs.pop("mpc.qp_backend") == "xla"
    differ = {k: (ours[k], theirs[k]) for k in shared - {"mpc.qp_backend"}
              if ours[k] != theirs[k]}
    assert not differ, differ
    cpu = bench_terminal_torch.config(30, "cpu")
    assert cpu.mpc.qp_backend == "xla"


def jax_lapack_sites():
    """The (module, name) bindings ``tools/bench_terminal.py`` assigns
    under ``USE_LAPACK``, read from its source, with ``koopmanx`` renamed
    ``koopmanx_torch``."""
    tree = ast.parse(open(os.path.join(TOOLS, "bench_terminal.py")).read())
    block = next(n for n in tree.body if isinstance(n, ast.If))
    alias = {}
    for node in block.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                alias[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                alias[a.asname or a.name] = a.name
    sites = set()
    for node in block.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                sites.add((alias[t.value.id], t.attr))
    return {(m.replace("koopmanx", "koopmanx_torch", 1), a)
            for m, a in sites}


def test_use_lapack_rebinds_the_jax_tools_call_sites():
    """``USE_LAPACK`` rebinds exactly the JAX tool's six call sites (the
    routines in ``ops/linalg.py`` and the names ``control/dare.py`` and
    ``control/qp.py`` imported), to the library's inverse and solve, and
    gives them back; the library ``spd_inverse`` adds its ridge."""
    import importlib

    from koopmanx_torch.ops import linalg

    sites = set(bench_terminal_torch.LAPACK_SITES)
    assert sites == jax_lapack_sites() and len(sites) == 6
    mods = {m: importlib.import_module(m) for m, _ in sites}
    own = {(m, a): getattr(mods[m], a) for m, a in sites}
    with bench_terminal_torch.library_routines():
        for m, a in sites:
            assert getattr(mods[m], a) is bench_terminal_torch.LIBRARY[a]
    assert {(m, a): getattr(mods[m], a) for m, a in sites} == own
    assert linalg.gj_inverse is own[("koopmanx_torch.ops.linalg",
                                     "gj_inverse")]
    k = torch.tensor(np.random.default_rng(0).normal(size=(3, 4, 4)))
    k = k @ k.transpose(-1, -2) + 4 * torch.eye(4, dtype=F64)
    torch.testing.assert_close(
        bench_terminal_torch.library_spd_inverse(k, block=2, eps=0.5),
        torch.linalg.inv(k + 0.5 * torch.eye(4, dtype=F64)), rtol=0, atol=0)


@pytest.mark.parametrize("lapack", ["0", "1"])
def test_bench_terminal_main_on_the_cpu(lapack, capsys):
    """``main`` at 4 scenarios and 2 steps on the CPU, each variant: the
    JAX tool's keys, the plain route (no launch), finite."""
    out = bench_terminal_torch.main({
        "BENCH_BATCH": "4", "BENCH_STEPS": "2", "USE_LAPACK": lapack,
        "BENCH_DEVICE": "cpu"})
    assert json.loads(capsys.readouterr().out) == out
    assert TERMINAL_KEYS <= set(out)
    assert out["lapack"] is (lapack == "1")
    assert (out["batch"], out["steps"], out["qp_backend"]) == (4, 2, "xla")
    assert out["box_admm_launches"] == 0 and out["finite"]
    assert out["per_step_ms"] > 0


# ---- the multi-process harness ---------------------------------------------------

def test_bench_multihost_two_gloo_ranks_on_the_cpu():
    """One spawn of the P = 2 job with ``--cpu`` at 4 scenarios a rank and
    3 steps: two gloo ranks, the JAX tool's keys, finite, within the
    rank timeout."""
    out = bench_multihost_torch.run_config(
        2, 4, 3, cpu=True, timeout=300,
        env={**os.environ, "KX_REPS": "2"})
    assert MULTIHOST_KEYS <= set(out)
    assert (out["procs"], out["batch_global"], out["steps"]) == (2, 8, 3)
    assert out["backend"] == "gloo" and out["finite"] is True
    assert len(out["rep_walls"]) == 2 and out["solves_per_s"] > 0
    assert out["box_admm_launches"] == 0


def test_bench_multihost_main_keys(monkeypatch, capsys):
    """``main`` assembles the JAX tool's record from its three settings
    (stood in for here by records of the settings' keys): the
    efficiencies from the solves/s, pinning with --cpu only."""
    calls = []

    def fake(nproc, batch, steps, cpu=False, pin_cores=False,
             distributed=True, timeout=None):
        assert timeout == 60.0
        calls.append((nproc, batch, steps, cpu, pin_cores, distributed))
        keys = CORUN_KEYS if not distributed and nproc > 1 else \
            MULTIHOST_KEYS
        rec = {k: 1 for k in keys}
        rec["solves_per_s"] = {1: 100.0}.get(nproc, 150.0 if distributed
                                             else 160.0)
        return rec

    monkeypatch.setattr(bench_multihost_torch, "run_config", fake)
    out = bench_multihost_torch.main(["--cpu", "--batch", "4", "--steps",
                                      "3", "--rank-timeout", "60"])
    assert json.loads(capsys.readouterr().out) == out
    assert MULTIHOST_TOP_KEYS <= set(out)
    pin = os.cpu_count() >= 2
    assert calls == [(1, 4, 3, True, pin, True), (2, 4, 3, True, pin, False),
                     (2, 4, 3, True, pin, True)]
    assert out["weak_scaling_efficiency"] == 0.75
    assert out["hardware_contention_efficiency"] == 0.8
    assert out["process_boundary_efficiency"] == round(150 / 160, 3)
    assert set(out["multi_process"]) == MULTIHOST_KEYS
    assert set(out["independent_corun"]) == CORUN_KEYS


# ---- no JAX, and the sweep ----------------------------------------------------------

TOOL_FILES = ("train_reference_scale_torch.py",
              "eval_encoder_both_metrics_torch.py",
              "bench_terminal_torch.py", "bench_multihost_torch.py")


@pytest.mark.parametrize("name", TOOL_FILES)
def test_tool_imports_no_jax(name):
    """No import of jax or of the JAX package, at any level."""
    tree = ast.parse(open(os.path.join(TOOLS, name)).read())
    for node in ast.walk(tree):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else [])
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "koopmanx"), m


def test_sweep_calls_the_port_tool_with_its_own_tags():
    """The sweep runs the JAX sweep's four runs through the port's tool,
    each with a tag of its own, logging into an ignored directory."""
    text = open(os.path.join(TOOLS, "sweep_kmae_r3_torch.sh")).read()
    jtext = open(os.path.join(TOOLS, "sweep_kmae_r3.sh")).read()
    runs = [line for line in text.splitlines() if line.startswith("run ")]
    jruns = [line for line in jtext.splitlines() if line.startswith("run ")]
    assert [r.split()[2:] for r in runs] == [r.split()[2:] for r in jruns]
    assert [r.split()[1] for r in runs] == [
        r.split()[1] + "_torch" for r in jruns]
    assert "tools/train_reference_scale_torch.py" in text
    assert "tools/train_reference_scale.py" not in text
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "logs/kmae_sweep_torch/" in ignored
