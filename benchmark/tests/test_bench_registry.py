"""A cell, a configuration, a traffic mix, a metric and a plant of the
reference that exist only as new files and entries in BENCHMARK.json are
found and run by the harness, which no edit of its code is needed for."""
import dataclasses
import json
import os
import shutil

from benchmark import run, spec

PENDULUM = '''"""The damped pendulum: x1' = x2, x2' = -a sin x1 - b x2 + k u."""
import torch


def vector_field(x, u, th):
    x1, x2 = x[..., 0], x[..., 1]
    dx2 = -th["a"] * torch.sin(x1) - th["b"] * x2 + th["k"] * u[..., 0]
    return torch.stack([x2, dx2], dim=-1)
'''


def _copy_benchmark(root):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(spec.ROOT, "artifacts"), root / "artifacts")
    return json.loads((root / "BENCHMARK.json").read_text())


def _pendulum_config():
    """A deployment of a plant the benchmark's reference has no file for:
    the pendulum under the in-repo KMAE encoder, square-root RLS."""
    from koopmanx_torch import configs as C
    from koopmanx_torch.control.terminal import synthesize_terminal
    from koopmanx_torch.run import engine_config
    from koopmanx_torch.systems.library import get_system
    import inspect

    changed = {"steps": 40, "switch_step": 20, "mpc.qp_backend": "pallas",
               "update.mode": "rls_sqrt"}
    cfg = C.PRESETS["pendulum_selftrained"]()
    cfg.steps, cfg.switch_step = 40, 20
    cfg.mpc.qp_backend, cfg.update.mode = "pallas", "rls_sqrt"
    system, ecfg = get_system("pendulum"), engine_config(cfg)
    engine = {k: getattr(ecfg, k) for k in ("qp_sigma", "qp_alpha",
                                            "qp_warm_start", "f_clamp",
                                            "model_guard")}
    engine["dare_iters"] = inspect.signature(
        synthesize_terminal).parameters["iters"].default
    return {"name": "pendulum_mlp", "source": "a test",
            "preset": "pendulum_selftrained", "changed": changed,
            "reduced": sorted(changed),
            "plant": {"system": "pendulum", "n": system.n, "m": system.m,
                      "theta0": {k: float(v) for k, v in system.theta0._asdict().items()},
                      "theta1": {k: float(v) for k, v in system.theta1._asdict().items()}},
            "engine": engine,
            "run_config": json.loads(json.dumps(dataclasses.asdict(cfg)))}


def test_new_cell_config_plant_and_metric_from_files_alone(tmp_path):
    root = tmp_path
    bench = _copy_benchmark(root)
    # the reference's plant, as a file of its own
    (root / "benchmark/reference/plants/pendulum.py").write_text(PENDULUM)
    # a configuration
    config = _pendulum_config()
    (root / "benchmark/configs/pendulum_mlp.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "pendulum_mlp", "source": config["source"],
                             "file": "benchmark/configs/pendulum_mlp.json",
                             "reduced": config["reduced"], "why": "a test"})
    # a traffic mix
    mix = json.loads((root / "benchmark/traffic/sweep-64k.json").read_text())
    mix.update(scenarios=16, check_scenarios=16, x0_range=[-1.0, 1.0])
    (root / "benchmark/traffic/sweep-tiny.json").write_text(json.dumps(mix))
    # the cell and its limits
    cell = "pendulum_mlp.sweep-tiny"
    bench["workloads"].append({"name": cell, "config": "pendulum_mlp",
                               "traffic": "sweep-tiny", "chips": 1,
                               "why": "a test"})
    limits = json.loads(
        (root / "benchmark/limits/duffing.sweep-256k.json").read_text())
    (root / f"benchmark/limits/{cell}.json").write_text(json.dumps(limits))
    # a metric, read in the new cell only
    (root / "benchmark/metrics/window_steps.py").write_text(
        "def read(rec):\n"
        "    return rec['solves'] / rec['batch'] if 'solves' in rec else None\n")
    for m in bench["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append(cell)
    bench["end_to_end"].append({"name": "window_steps", "unit": "steps",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run.run(str(root), cell, 99, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    # the residuals hold the program's logged lifted residual against the
    # reference's own plant step: the new file is the plant it steps
    assert out["checks"]["res.start"]["value"] < 1e-4
    assert out["checks"]["res.last"]["value"] < 1e-4
    metrics = out["metrics"]
    assert set(metrics) == {"solves_per_s", "setup_s", "window_steps"}
    assert metrics["window_steps"]["value"] % 10 == 0
    assert out["attempted"] == 16 * metrics["window_steps"]["value"]
    # the existing cells' metrics are unchanged by the new entries
    assert [m["name"] for m in spec.end_to_end(bench, "revise2.sweep-64k")] == [
        "solves_per_s.revise2", "setup_s"]
