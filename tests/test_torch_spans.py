"""The program's spans and counters (``koopmanx_torch/utils/profiling.py``)
on the CPU: off, they open no range and count nothing; on, the closed
loop's carry and logs are the same bit for bit, the counts are those of
the work (lifts a solve, models held by the guard), and under
``torch.profiler`` the ``kx.*`` spans nest as the step runs them, the
step's span carrying its index. The flagship and Revise_2 presets, 16
scenarios, float32, the kernel route (its plain version on the CPU); and
the Woodbury lane's spans and counters in the benchmark's
``duffing_rbf128`` (nlift 128), off at no operation's cost."""
import collections
import json

import pytest

torch = pytest.importorskip("torch")

from koopmanx_torch import configs as C  # noqa: E402
from koopmanx_torch.engine.controller import BatchedController  # noqa: E402
from koopmanx_torch.engine.scenario import sample_scenarios  # noqa: E402
from koopmanx_torch.run import (build_pipeline, run_scenarios,  # noqa: E402
                                with_engine_config)
from koopmanx_torch.systems.library import get_system  # noqa: E402
from koopmanx_torch.utils import profiling  # noqa: E402

BATCH, STEPS = 16, 4
PRESETS = ["duffing", "revise2_duffing"]
# the outermost dictionary calls of a step: psi(x) and psi(x+); Revise_2
# adds psi(x - r) in the synthesis and psi(x - r), psi(e) in its monitors
LIFTS_PER_SOLVE = {"duffing": 2, "revise2_duffing": 5}
# each span's nearest enclosing span
PARENT = {"kx.control_solve": "kx.step", "kx.qp_build": "kx.control_solve",
          "kx.qp_solve": "kx.control_solve", "kx.kkt_inverse": "kx.qp_solve",
          "kx.admm": "kx.qp_solve", "kx.terminal": "kx.control_solve",
          "kx.plant": "kx.step", "kx.estimator": "kx.step",
          "kx.model_guard": "kx.estimator"}


@pytest.fixture(scope="module")
def pipes():
    out = {}
    for name in PRESETS:
        cfg = C.PRESETS[name]()
        cfg.steps = STEPS
        cfg.mpc.qp_backend = "pallas"
        cfg.lift.weights_path = "artifacts/duffing_kmae_encoder.mat"
        pipe = build_pipeline(cfg, device="cpu")
        sc = sample_scenarios(get_system(cfg.system),
                              torch.Generator().manual_seed(0), BATCH,
                              param_scale=0.15, device="cpu")
        out[name] = (pipe, sc)
    return out


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable(False)
    yield
    profiling.enable(False)


def _run(pipe, sc, on):
    profiling.enable(on)
    out = run_scenarios(pipe, sc)
    counts = profiling.counters()
    profiling.enable(False)
    return out, counts


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


@pytest.mark.parametrize("name", PRESETS)
def test_spans_off_open_nothing_and_count_nothing(pipes, name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    (carry, log), counts = _run(*pipes[name], on=False)
    assert counts == {}
    assert torch.isfinite(log.x).all()
    # and the same loop with the spans on reaches the refusal
    with pytest.raises(AssertionError, match="span opened"):
        _run(*pipes[name], on=True)


@pytest.mark.parametrize("name", PRESETS)
def test_loop_is_the_same_bit_for_bit_with_spans_on(pipes, name):
    off, _ = _run(*pipes[name], on=False)
    on, counts = _run(*pipes[name], on=True)
    a, b = _leaves(off), _leaves(on)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert counts["step.rows"] == BATCH * STEPS


@pytest.mark.parametrize("name", PRESETS)
def test_lifts_per_solve(pipes, name):
    _, counts = _run(*pipes[name], on=True)
    assert counts["lift.rows"] == LIFTS_PER_SOLVE[name] * counts["step.rows"]
    assert counts["model_guard.rows"] == BATCH * STEPS
    if name == "revise2_duffing":
        assert counts["terminal.rows"] == BATCH * STEPS
        assert 0 <= counts["terminal.held"] <= BATCH * STEPS
    else:
        assert "terminal.rows" not in counts


def test_a_guard_that_every_model_fails_holds_every_model(pipes):
    pipe, sc = pipes["duffing"]
    strict = with_engine_config(pipe, model_guard=1e-12)
    (carry, _), counts = _run(strict, sc, on=True)
    assert counts["model_guard.held"] == BATCH * STEPS
    assert counts["model_guard.rows"] == BATCH * STEPS
    # every model held: the carry's model is the starting one
    assert torch.equal(carry.model.A, pipe.model0.A.expand_as(carry.model.A))


def _kx_parent(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("kx."):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


@pytest.mark.parametrize("name", PRESETS)
def test_spans_nest_as_the_step_runs_them(pipes, name):
    from torch.profiler import ProfilerActivity, profile

    pipe, sc = pipes[name]
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run_scenarios(pipe, sc)
    profiling.enable(False)
    spans = [e for e in prof.events() if e.name.startswith("kx.")]
    names = {e.name for e in spans}
    want = set(PARENT) | {"kx.step", "kx.lift"}
    if name != "revise2_duffing":
        want.discard("kx.terminal")
    assert names == want
    steps = [e for e in spans if e.name == "kx.step"]
    assert [e.kwinputs for e in steps] == [{"step": k} for k in range(STEPS)]
    for e in spans:
        if e.name == "kx.step":
            assert _kx_parent(e) is None
        elif e.name == "kx.lift":
            # psi(x - r) of the synthesis runs inside the control solve
            assert _kx_parent(e) in ("kx.step", "kx.control_solve")
        else:
            assert _kx_parent(e) == PARENT[e.name], e.name
    per_step = sum(e.name == "kx.lift" for e in spans) / STEPS
    assert per_step == LIFTS_PER_SOLVE[name]


def test_the_served_step_is_a_span_of_its_own(pipes):
    """``BatchedController.step``: one ``kx.step`` a call, one lift a
    call (the previous measurement's lift is carried)."""
    pipe, sc = pipes["duffing"]
    ctrl = BatchedController.from_pipeline(pipe, BATCH)
    profiling.enable(True)
    x = sc.x0
    for _ in range(3):
        ctrl.step(x)
    counts = profiling.counters()
    assert counts["step.rows"] == 3 * BATCH
    assert counts["lift.rows"] == 3 * BATCH
    # the estimator runs every call (a first call drops what it gives)
    assert counts["model_guard.rows"] == 3 * BATCH


def test_trace_writes_the_counters(pipes, tmp_path):
    pipe, sc = pipes["duffing"]
    with profiling.trace(str(tmp_path / "t")):
        run_scenarios(pipe, sc)
    assert not profiling.enabled()
    counts = json.loads((tmp_path / "t" / "counters.json").read_text())
    assert counts["step.rows"] == BATCH * STEPS
    assert counts["lift.rows"] == 2 * BATCH * STEPS
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    steps = [e for e in trace["traceEvents"] if e.get("name") == "kx.step"]
    assert [e["args"]["step"] for e in steps] == list(range(STEPS))


# -- the Woodbury lane of the windowed estimator (duffing_rbf128) ---------

WINDOW_SPANS = ("kx.window_motion", "kx.window_sm", "kx.window_polish",
                "kx.window_write", "kx.window_model")


@pytest.fixture(scope="module")
def woodbury():
    """The benchmark's ``duffing_rbf128`` (its pinned centers, nlift 128, the
    window of 256) at 4 steps, its pipeline and scenarios."""
    from benchmark import spec

    cfg = C.RunConfig.from_dict(
        spec.part(spec.ROOT, "configs", "duffing_rbf128")["run_config"])
    cfg.steps = STEPS
    pipe = build_pipeline(cfg, device="cpu")
    sc = sample_scenarios(get_system(cfg.system),
                          torch.Generator().manual_seed(0), BATCH,
                          param_scale=0.15, device="cpu")
    return pipe, sc


def _update_args(pipe, sc, batch=BATCH):
    from koopmanx_torch.run import replicate

    state = replicate(pipe.rls0, batch)
    z = pipe.dictionary(sc.x0[:batch])
    u = torch.full((batch, 1), 0.5)
    return state, z, u, z.flip(-1), sc.x0[:batch]


def _op_names(fn):
    """The names of the spans and of the outermost operations ``fn`` runs
    (those under no other operation: a span is none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()

    def outermost(e):
        parent = e.cpu_parent
        while parent is not None and parent.name.startswith("kx."):
            parent = parent.cpu_parent
        return parent is None

    return [e.name for e in prof.events()
            if e.name.startswith("kx.") or outermost(e)]


def test_woodbury_spans_add_no_operation_when_off(woodbury, monkeypatch):
    """Off, ``window_update_carry`` and ``window_model_carry`` record no
    span and launch what they did before the spans: on, the only
    operations added are the spans and the safeguard's count (one sum an
    inverse), the counter's own accumulation left out. Outermost
    operations: a sum of booleans runs a cast inside it."""
    from koopmanx_torch.edmd.windowed import (window_model_carry,
                                              window_update_carry)

    pipe, sc = woodbury
    args = _update_args(pipe, sc)
    run = lambda: window_model_carry(window_update_carry(*args, polish=2),
                                     pipe.dictionary.nlift)
    monkeypatch.setattr(profiling, "count_device", lambda name, t: None)
    off = _op_names(run)
    profiling.enable(True)
    on = _op_names(run)
    profiling.enable(False)
    assert not any(n.startswith("kx.") for n in off)
    spans = collections.Counter(n for n in on if n.startswith("kx."))
    assert spans == collections.Counter(WINDOW_SPANS)
    added = (collections.Counter(n for n in on if not n.startswith("kx."))
             - collections.Counter(off))
    assert added == collections.Counter({"aten::sum": 2})
    assert not collections.Counter(off) - collections.Counter(on)


def test_woodbury_counters_count_the_rows(woodbury):
    (carry, log), counts = _run(*woodbury, on=True)
    assert counts["window.rows"] == BATCH * STEPS
    assert counts["window.reseeded"] == 0
    assert torch.isfinite(log.x).all()


def test_woodbury_spans_nest_in_the_estimator(woodbury):
    from torch.profiler import ProfilerActivity, profile

    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_scenarios(*woodbury)
    profiling.enable(False)
    spans = [e for e in prof.events() if e.name in WINDOW_SPANS]
    assert collections.Counter(e.name for e in spans) == {
        name: STEPS for name in WINDOW_SPANS}
    assert all(_kx_parent(e) == "kx.estimator" for e in spans)


@pytest.mark.parametrize("poisoned", [1, 3])
def test_a_poisoned_inverse_is_reseeded_and_counted(woodbury, poisoned):
    """NaN in the carried inverse of the first ``poisoned`` scenarios: the
    safeguard re-seeds exactly those, and counts each once."""
    from koopmanx_torch.edmd.windowed import window_update_carry

    pipe, sc = woodbury
    state, *rows = _update_args(pipe, sc)
    g_inv = state.g_inv.clone()
    g_inv[:poisoned] = float("nan")
    profiling.enable(True)
    new = window_update_carry(state._replace(g_inv=g_inv), *rows, polish=2)
    counts = profiling.counters()
    profiling.enable(False)
    assert counts["window.reseeded"] == poisoned
    assert counts["window.rows"] == BATCH
    assert torch.isfinite(new.g_inv).all()
