"""``python -m koopmanx_torch.cli`` against ``koopmanx.cli``: the override
typing, the RunConfig JSON files of both packages, the preset listing, the
``run``, ``sweep``, ``validate`` and ``modes`` subcommands on the CPU, the
refused subcommands and flags, and the refusal to run on the CPU unasked."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from koopmanx import cli as jcli  # noqa: E402
from koopmanx import configs as JC  # noqa: E402

from koopmanx_torch import cli  # noqa: E402
from koopmanx_torch import configs as TC  # noqa: E402
from koopmanx_torch.ops.box_admm import box_admm  # noqa: E402

SMALL = ["-o", "data.n_step=20", "-o", "data.n_traj=20"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _json(capsys):
    return json.loads(capsys.readouterr().out)


def test_apply_overrides_types():
    """Each value typed as the field it replaces, as in the JAX CLI."""
    items = ["steps=42", "mpc.qp_iters=99", "mpc.q_weight=12.5",
             "lift.normalize=false", "update.mode=storage",
             "mpc.qp_backend=xla", "update.warm_start_from_batch=1"]
    ours = cli._apply_overrides(TC.duffing_nn_preset(), items)
    theirs = jcli._apply_overrides(JC.duffing_nn_preset(), items)
    assert ours.steps == 42 and ours.mpc.qp_iters == 99
    assert ours.mpc.q_weight == 12.5 and ours.lift.normalize is False
    assert ours.update.mode == "storage"
    assert ours.update.warm_start_from_batch is True
    for key in ("mpc", "update"):
        assert dataclasses.asdict(getattr(ours, key)) == dataclasses.asdict(
            getattr(theirs, key))


@pytest.mark.parametrize("name", sorted(TC.PRESETS))
def test_run_config_json_round_trip(name):
    """Every preset through ``to_json`` and ``from_json`` comes back equal
    (the JSON lists back as tuples), and the JAX package's ``to_json`` of
    the same preset reads into a port config with the same fields and
    values, up to the weights path, which each package resolves itself."""
    cfg = TC.PRESETS[name]()
    assert TC.RunConfig.from_json(cfg.to_json()) == cfg
    from_jax = TC.RunConfig.from_json(JC.PRESETS[name]().to_json())
    ours, theirs = (json.loads(c.to_json()) for c in (cfg, from_jax))
    for d in (ours, theirs):
        d["lift"].pop("weights_path")
    assert ours == theirs


def test_presets_lists_the_jax_presets(capsys):
    """``presets`` prints the JAX CLI's lines, preset for preset."""
    cli.main(["presets"])
    ours = capsys.readouterr().out
    jcli.main(["presets"])
    assert ours == capsys.readouterr().out
    assert len(ours.splitlines()) == 16


def test_run_on_the_cpu(capsys, tmp_path):
    """``run --cpu --preset duffing --steps 60``: the JAX CLI's summary
    keys, finite values, |u| within the box, no kernel launch; with
    ``--save-log`` and ``--archive --mat`` the files appear."""
    launches = box_admm.launches
    log = tmp_path / "log.npz"
    cli.main(["run", "--cpu", "--preset", "duffing", "--steps", "60",
              "--save-log", str(log), "--archive", str(tmp_path / "bundle"),
              "--mat", *SMALL])
    ours = _json(capsys)
    jcli.main(["run", "--cpu", "--preset", "duffing", "--steps", "30",
               *SMALL])
    theirs = _json(capsys)
    assert box_admm.launches == launches
    assert ours.keys() == theirs.keys()
    assert ours["steps"] == 60 and ours["system"] == "duffing"
    assert all(np.isfinite(v) for k, v in ours.items()
               if isinstance(v, float))
    assert np.isfinite(ours["final_state"]).all()
    assert ours["u_abs_max"] <= 2.0
    with np.load(log) as saved:
        assert sorted(saved.files) == sorted(
            ["x", "u", "r", "drift_a", "drift_b", "drift_c", "residual"])
        assert saved["x"].shape == (60, 2)
    assert (tmp_path / "bundle.npz").exists()
    assert (tmp_path / "bundle.mat").exists()


def test_run_reads_a_config_file_written_by_jax(capsys, tmp_path):
    """``run --config`` on a JSON file the JAX package wrote, ``--x64``
    runs it in float64 (the final state and the log's dtype)."""
    cfg = JC.tank_preset()
    cfg.steps = 20
    cfg.data = JC.DataConfig(n_step=20, n_traj=20, u_range=(-5.0, 5.0),
                             clamp_x0=True)
    path = tmp_path / "tank.json"
    path.write_text(cfg.to_json())
    log = tmp_path / "log.npz"
    cli.main(["run", "--cpu", "--x64", "--config", str(path), "--save-log",
              str(log)])
    summary = _json(capsys)
    assert summary["system"] == "tank" and summary["steps"] == 20
    assert summary["u_abs_max"] <= 8.0
    with np.load(log) as saved:
        assert saved["x"].dtype == np.float64


def test_sweep_validate_and_modes_on_the_cpu(capsys):
    """``sweep`` at 8 plants, ``validate`` at 50 steps, ``modes``: the JAX
    CLI's keys, finite values."""
    cli.main(["sweep", "--cpu", "--preset", "duffing", "--batch", "8",
              "--steps", "20", *SMALL])
    sweep = _json(capsys)
    assert sweep["scenarios"] == 8 and sweep["steps"] == 20
    assert sweep["finite_fraction"] == 1.0
    assert set(sweep) == {
        "system", "scenarios", "steps", "param_scale", "wall_s",
        "solves_per_s", "finite_fraction", "tracking_err_mean",
        "tracking_err_p95", "tracking_err_max"}
    cli.main(["validate", "--cpu", "--preset", "duffing", "--steps", "50"])
    val = _json(capsys)
    assert val["steps"] == 50
    assert np.isfinite(val["rmse"]) and np.isfinite(
        val["rmse_reference_formula"])
    cli.main(["modes", "--cpu", "--preset", "duffing", *SMALL])
    modes = _json(capsys)
    assert modes["nlift"] == 8 and modes["model"] == "batch-EDMD model"
    assert np.isfinite(modes["spectral_radius"])


@pytest.mark.parametrize("argv,item", [
    (["bench"], "L5"),
    (["train", "--cpu"], "item 18"),
    (["run", "--cpu", "--figures", "out"], "item 21"),
    (["modes", "--cpu", "--figures", "out"], "item 21"),
])
def test_refused_subcommands_name_their_item(argv, item, capsys, tmp_path):
    """The subcommands and flags of later items raise, naming their ROADMAP
    item. ``train`` (item 18) is ported: at a tiny size it trains and
    prints the last epoch's record (tests/test_torch_train.py holds it to
    the JAX package). ``--figures`` (item 21) is ported: ``run`` writes
    the figure set and ``modes`` its two figures under the prefix
    (tests/test_torch_plots.py holds them to the JAX package's)."""
    if item == "item 21":
        prefix = str(tmp_path / argv[-1])
        cli.main([*argv[:-1], prefix, *SMALL, "--steps", "20"])
        capsys.readouterr()
        names = sorted(os.listdir(tmp_path))
        want = ({"out_eigenfunctions.png", "out_spectrum.png"}
                if argv[0] == "modes" else
                {"out_tracking.png", "out_drift.png", "out_input.png",
                 "out_phase.png", "out_training_scatter.png",
                 "out_reconstruction.png", "out_spectrum.png",
                 "out_eigenfunctions.png"})
        assert want <= set(names), names
        return
    if argv[0] == "train":
        cli.main([*argv, "--n-step", "10", "--n-traj", "8", "--hidden", "8",
                  "--nlift", "4", "--pred-horizon", "3", "--epochs", "1"])
        out = capsys.readouterr().out
        final = json.loads(out[out.index("\n{") + 1:])["final"]
        assert final["epoch"] == 0 and np.isfinite(final["loss"])
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        cli.main(argv)


def test_run_without_cpu_needs_a_card():
    """Without ``--cpu`` the CLI runs on the card; with none it raises and
    does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "--preset", "duffing", "--steps", "5"])


def test_route_follows_the_device():
    """The card takes the kernel route and the CPU the plain one; an
    override wins."""
    args = lambda *a: type("A", (), dict(preset="duffing", steps=None,
                                         override=list(a), x64=False,
                                         config=None, cpu=False))()
    assert cli._config(args()).mpc.qp_backend == "pallas"
    assert cli._config(args("mpc.qp_backend=xla")).mpc.qp_backend == "xla"
    cpu = args()
    cpu.cpu = True
    assert cli._config(cpu).mpc.qp_backend == "xla"
