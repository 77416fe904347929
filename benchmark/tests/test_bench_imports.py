"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference is independent of the program."""
import ast
import os
import sys
import types

import pytest

from benchmark import check, run, spec

BENCH = os.path.join(spec.ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole():
    names = ["koopmanx_torch", "koopmanx_torch.run", "jaxtyping", "flaxen",
             "numpy", "koopmanx", "koopmanx.run", "jax.numpy", "jaxlib",
             "flax.linen"]
    assert check.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "koopmanx", "koopmanx.run"]


@pytest.mark.parametrize("path", sorted(_sources(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(check.FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "koopmanx_torch" not in tops and "benchmark" not in tops, path


def test_a_loaded_jax_stops_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(ImportError, match="jax"):
        run.run(spec.ROOT, "duffing.sweep-256k", 3, 0.1, False, device="cpu",
                overrides={"scenarios": 8, "check_scenarios": 8})


def test_without_a_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "duffing.sweep-256k", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
