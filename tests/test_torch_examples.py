"""The port's four examples (``examples/*_torch.py``) end to end with
``--cpu`` at tests/test_examples.py's reduced sizes, each figure written;
none imports JAX or the JAX package."""
import ast
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("duffing_comparison_torch", "local_linear_comparison_torch",
            "tank_delta_u_torch", "tune_weights_torch")


def _path(name):
    return os.path.join(ROOT, "examples", f"{name}.py")


def _example(name):
    spec = importlib.util.spec_from_file_location(name, _path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(name):
    """Every import of the example, at any depth, is neither ``jax`` nor
    the JAX package ``koopmanx``."""
    tree = ast.parse(open(_path(name)).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "koopmanx_torch" in roots
    assert not roots & {"jax", "jaxlib", "koopmanx", "optax"}, roots


def test_duffing_comparison_example(tmp_path, capsys):
    out = tmp_path / "cmp.png"
    _example("duffing_comparison_torch").main(
        ["--cpu", "--steps", "120", "--switch", "40", "--out", str(out)])
    text = capsys.readouterr().out
    assert "update=off" in text and "update=rls_sqrt" in text
    assert "box-ADMM kernel launches: 0" in text  # the plain route
    assert os.path.getsize(out) > 1000


def test_local_linear_comparison_example(tmp_path, capsys):
    out = tmp_path / "ll.png"
    metrics = _example("local_linear_comparison_torch").main(
        ["--cpu", "--steps", "80", "--out", str(out)])
    text = capsys.readouterr().out
    assert "koopman" in text and "local_linear" in text
    assert all(m["u_abs_max"] <= 2.0 for m in metrics.values())
    assert os.path.getsize(out) > 1000


def test_tank_delta_u_example(tmp_path, capsys):
    out = tmp_path / "tank.png"
    result = _example("tank_delta_u_torch").main(
        ["--cpu", "--steps", "300", "--out", str(out)])
    assert "steady-state error" in capsys.readouterr().out
    m = result["metrics"]
    assert -8.0 <= m["u_min"] <= m["u_max"] <= 8.0
    assert os.path.getsize(out) > 1000


def test_tune_weights_example(capsys):
    trajectory = _example("tune_weights_torch").main(
        ["--cpu", "--steps", "30", "--iters", "2"])
    text = capsys.readouterr().out
    assert text.startswith("init: r=1.00e+00") and "tuned: r=" in text
    assert len(trajectory) == 2
    assert all(torch.isfinite(torch.tensor([rec["cost"], rec["grad"]])).all()
               for rec in trajectory)


def test_tune_weights_remat_same_steps():
    """``--remat`` checkpoints each step: the same Adam trajectory in
    float32 as the stored graph, at a few steps."""
    tune_mod = _example("tune_weights_torch")
    from koopmanx_torch.run import build_pipeline

    cfg = tune_mod.tune_config(steps=12)
    pipe = build_pipeline(cfg, device="cpu")
    plain = tune_mod.tune(cfg, 2, pipe=pipe)
    remat = tune_mod.tune(cfg, 2, pipe=pipe, remat=True)
    for a, b in zip(plain, remat):
        assert a["log_r"] == b["log_r"] and a["grad"] == b["grad"]
