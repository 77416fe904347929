"""The reading of a stretch with the program's own spans and counters
(``benchmark/program.py``), on synthetic profiler events as
``test_bench_trace.py`` builds them: the device-side annotations of the
spans and of the benchmark's ranges are not operations, a span's self
time leaves out what the spans it holds hold, an operation attached to a
launch stall as well counts once, and a stretch whose ``kx.step`` spans
hold more than it was busy is refused. Then ``benchmark/tools/spans.py``
on a small fleet on the CPU, where the stretch has counters and no device
operations."""
import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Kernel

from benchmark import program


def _host(name, start, end, kernels=()):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[Kernel(k, 0, us) for k, us in kernels])


def _device(name, start, end):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[])


def _prof(events):
    from types import SimpleNamespace

    return SimpleNamespace(events=lambda: events)


def _stretch(extra_host=(), extra_device=()):
    """One step: the lift (inside the benchmark's ``lift`` range), the
    control solve (the QP build, then the QP solve: the KKT inverse and
    the ADMM, then an operation of its own), an operation of the step's
    own, and one outside the step. Each span and range has its
    device-side annotation attached."""
    host = [
        _host("kx.step", 0, 100, [("kx.step", 150.0)]),
        _host("lift", 2, 8, [("lift", 5.0)]),
        _host("kx.lift", 3, 7, [("kx.lift", 4.0)]),
        _host("aten::mm", 4, 5, [("gemm", 10.0)]),
        _host("kx.control_solve", 10, 60),
        _host("kx.qp_build", 12, 30),
        _host("aten::bmm", 14, 15, [("bmm", 20.0)]),
        _host("kx.qp_solve", 35, 55),
        _host("kx.kkt_inverse", 36, 40),
        _host("aten::inv", 37, 38, [("inv", 6.0)]),
        _host("kx.admm", 41, 50),
        _host("box_admm_launch", 42, 43, [("box_admm", 4.0)]),
        _host("aten::add", 57, 58, [("add", 3.0)]),
        _host("aten::norm", 80, 81, [("norm", 2.0)]),
        _host("aten::sum", 150, 151, [("sum", 1.0)]),
        *extra_host,
    ]
    device = [_device("kx.step", 0, 150), _device("lift", 3, 8),
              _device("kx.lift", 3, 7),
              _device("gemm", 5, 15), _device("bmm", 16, 36),
              _device("inv", 38, 44), _device("box_admm", 44, 48),
              _device("add", 60, 63), _device("norm", 90, 92),
              _device("sum", 200, 201), *extra_device]
    return _prof(host + device)


def test_annotations_are_not_operations():
    out = program.read(_stretch())
    assert out["device_ops"] == 7
    assert out["busy_us"] == 46.0
    assert out["span_us"] == {"kx.step": 45.0, "kx.lift": 10.0,
                              "kx.control_solve": 33.0, "kx.qp_build": 20.0,
                              "kx.qp_solve": 10.0, "kx.kkt_inverse": 6.0,
                              "kx.admm": 4.0}
    assert out["range_us"] == {"lift": 10.0}
    assert ["kx.step <- kx.step", 1, 150.0] in out["dropped"]


def test_self_time_leaves_out_the_spans_held():
    own = program.read(_stretch())["self_us"]
    assert own == {"kx.step": 2.0, "kx.lift": 10.0, "kx.control_solve": 3.0,
                   "kx.qp_build": 20.0, "kx.kkt_inverse": 6.0,
                   "kx.admm": 4.0}


def test_idle_gaps_by_the_innermost_span():
    idle = dict(program.read(_stretch())["idle_top"])
    assert idle == pytest.approx({
        "kx.qp_build": 1e-6, "kx.kkt_inverse": 2e-6, "kx.qp_solve": 12e-6,
        "kx.step": 27e-6, "outside kx.step": 108e-6})


def test_an_operation_attached_to_a_launch_stall_counts_once():
    # the profiler's stall marker, inside the QP build on the host, holds
    # a copy of the step's own norm
    stall = [_host("Command Buffer Full", 20, 21, [("norm", 2.0)])]
    out = program.read(_stretch(stall))
    assert out["span_us"]["kx.qp_build"] == 20.0
    assert out["span_us"]["kx.step"] == 45.0
    assert out["self_us"]["kx.step"] == 2.0
    assert ["Command Buffer Full <- norm", 1, 2.0] in out["dropped"]


def test_steps_holding_more_than_the_busy_time_are_refused():
    # two operations at once (two streams): the spans hold their sum, the
    # busy time their union
    div = ([_host("aten::div", 85, 86, [("div", 8.0)])],
           [_device("div", 60, 68)])
    with pytest.raises(ValueError, match="more than the stretch's busy"):
        program.read(_stretch(*div))


def test_the_summary_puts_each_span_beside_its_range():
    prog = dict(program.read(_stretch()), steps=2,
                counters={"step.rows": 10, "lift.rows": 20})
    text = program.summary(prog)
    assert "kx.lift 0.0050 (range lift 0.0050)" in text
    assert "kx.qp_build 0.0100;" in text
    assert "outside kx.step 0.0540" in text


def test_a_program_without_spans_gives_no_stretch(monkeypatch):
    from koopmanx_torch.utils import profiling

    ran = []
    monkeypatch.delattr(profiling, "enable")
    assert program.stretch(lambda: ran.append(1), 2, 20, "cpu") is None
    assert ran == []


def test_a_stretch_on_the_cpu_counts_with_the_spans_on():
    from koopmanx_torch.utils import profiling

    def run():
        assert profiling.enabled()
        profiling.count("step.rows", 4)

    out = program.stretch(run, 2, 20, "cpu")
    assert not profiling.enabled()
    assert out["counters"] == {"step.rows": 8} and out["steps"] == 20
    assert out["busy_us"] == 0.0 and out["span_us"] == {}


def test_the_spans_tool_on_a_small_fleet(capsys):
    from benchmark import spec
    from benchmark.run import Cell
    from benchmark.tools import spans

    small = {"scenarios": 8, "check_scenarios": 8}
    cell = Cell(spec.ROOT, "duffing.sweep-256k", 3000000019, device="cpu",
                trace=True, overrides=small)
    timed = spans.cost(cell, 1)
    assert len(timed["ms_per_step_off"]) == len(timed["ms_per_step_on"]) == 1
    out = spans.profiled(cell, 3000000019, 0.1)
    assert "program counters" in capsys.readouterr().err
    assert out["counters"]["step.rows"] == 8 * 20
    assert out["lifts_per_solve"] == 2.0
    assert out["model_held_share"] == 0.0 and out["cert_held_share"] is None
    assert out["span_ms"] == {} and out["busy_ms"] == 0.0
