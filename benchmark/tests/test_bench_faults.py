"""The comparison fails where it should: the control (the reference in
float32 with TF32 products, put in the program's place) and the faults a
cell can have, each planted underneath a whole run of the harness on the
CPU at a small fleet. None of the cells spans chips, so none can lose an
exchange between them."""
import pytest
import torch

from benchmark import run, spec
from benchmark.reference import F64, TF32

SMALL = {"scenarios": 24, "check_scenarios": 24}
CELLS = ["duffing.sweep-256k", "revise2.sweep-64k", "duffing.serve-64k"]


def _run(cell, root=spec.ROOT):
    return run.run(root, cell, 4_294_967_311, 0.3, False, device="cpu",
                   overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(cell, root_of):
    c = run.Cell(root_of(cell), cell, 123456789012, device="cpu", overrides=SMALL)
    c.window(123456789012, 0.3)
    sel = c.selection(123456789012)
    from benchmark.check import judge

    assert judge(c.numbers(sel, F64), c.limits)
    control = c.numbers(sel, TF32)
    assert not judge(control, c.limits)
    assert any(v > c.limits[k] for k, v in control.items())


def _patch_solver(monkeypatch, change):
    """``change(u) -> u`` applied to every applied input where the control
    solve produces it, in the loop and in the serving controller."""
    from koopmanx_torch.engine import controller, loop

    for module in (loop, controller):
        make = module.make_control_solver

        def patched(*args, _make=make, **kwargs):
            solve = _make(*args, **kwargs)

            def inner(*a, **k):
                dec = solve(*a, **k)
                return dec._replace(u_applied=change(dec.u_applied))

            return inner

        monkeypatch.setattr(module, "make_control_solver", patched)


def _half_batch(u):
    """Half of the fleet left out: its inputs the mean of the rest's."""
    half = u.shape[0] // 2
    return torch.cat([u[:half], u[:half].mean(0, keepdim=True).expand(
        u.shape[0] - half, -1)])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, cell, fault,
                                               root_of):
    change = {"altered": lambda u: u + 0.1, "half_batch": _half_batch}[fault]
    _patch_solver(monkeypatch, change)
    out = _run(cell, root_of(cell))
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch, cell,
                                                           root_of):
    from koopmanx_torch.engine import controller, loop

    # the loop's plant, or the serving step's fleet state, left as it was
    monkeypatch.setattr(loop, "make_step",
                        lambda *a, **k: (lambda x, u, theta: x))
    make = controller.make_step_fn

    def frozen(*args, **kwargs):
        step_fn = make(*args, **kwargs)
        return lambda params, state, x, step: (state, step_fn(
            params, state, x, step)[1])

    monkeypatch.setattr(controller, "make_step_fn", frozen)
    out = _run(cell, root_of(cell))
    assert not out["correct"]


def test_a_dropped_certificate_gain_is_caught(monkeypatch):
    """The terminal synthesis's gain K set to zero where it is produced:
    the QP reads only P, so the certificate's own comparison catches it."""
    from koopmanx_torch.engine import core

    make = core.synthesize_terminal

    def dropped(*args, **kwargs):
        tc = make(*args, **kwargs)
        return tc._replace(k=torch.zeros_like(tc.k))

    monkeypatch.setattr(core, "synthesize_terminal", dropped)
    out = _run("revise2.sweep-64k")
    assert not out["correct"]
    assert out["checks"]["cert_k.last"]["value"] > out["checks"]["cert_k.last"]["limit"]
