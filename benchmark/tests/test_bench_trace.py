"""The reading of a profiled stretch: the device time under each range, a
range's own device-side annotation left out, a range nested in one of its
own name counted once, a device operation attached to two host operations
counted once (a host operation before a launch stall), and a stretch whose ranges hold more device time than it was
busy refused."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Kernel

from benchmark import trace


def _host(name, start, end, kernels=()):
    return SimpleNamespace(name=name, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[Kernel(k, 0, us) for k, us in kernels])


def _device(name, start, end):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start, end=end),
                           kernels=[])


def _prof(events):
    return SimpleNamespace(events=lambda: events)


def _stretch(extra_host=(), annotate=True):
    host = [
        # control_solve [0, 100] holds qp_solve [40, 60]; the range's own
        # device annotation (120 us, idle included) is attached to it
        _host("control_solve", 0, 100,
              [("control_solve", 120.0)] if annotate else []),
        _host("aten::mm", 10, 12, [("gemm", 30.0)]),
        _host("qp_solve", 40, 60, [("box_admm", 20.0)]),
        _host("aten::add", 70, 71, [("add", 5.0)]),
        _host("estimator", 150, 200),
        _host("aten::mul", 160, 161, [("mul", 8.0)]),
        _host("aten::sum", 300, 301, [("sum", 2.0)]),  # under no range
        *extra_host,
    ]
    device = [_device("gemm", 1000, 1030), _device("box_admm", 1030, 1050),
              _device("add", 1050, 1055), _device("mul", 1060, 1068),
              _device("sum", 1070, 1072)]
    if annotate:
        device.append(_device("control_solve", 1000, 1120))
    return _prof(host + device)


def test_stage_times_leave_the_annotations_out():
    out = trace.read_ranges(_stretch())
    assert out["stage_us"] == {"control_solve": 55.0, "qp_solve": 20.0,
                               "estimator": 8.0}
    assert out["ranged_us"] == 63.0
    assert out["ranges_busy_us"] == 65.0


def test_a_range_nested_in_its_own_name_counts_once():
    inner = [_host("control_solve", 5, 50)]
    assert trace.read_ranges(_stretch(inner))["stage_us"]["control_solve"] == 55.0


def test_a_device_operation_attached_twice_counts_once():
    twice = [_host("aten::copy_", 165, 166, [("gemm", 30.0)])]
    out = trace.read_ranges(_stretch(twice))
    assert out["stage_us"]["estimator"] == 8.0
    assert out["ranged_us"] == 63.0
    assert ["aten::copy_ <- gemm", 1, 30.0] in out["dropped"]
    assert ["control_solve <- control_solve", 1, 120.0] in out["dropped"]


def test_a_launch_stall_gives_way_to_the_operation():
    # the profiler's stall marker, earlier in host time inside another
    # range, holds a copy of the estimator's device operation
    stall = [_host("Command Buffer Full", 20, 21, [("mul", 8.0)])]
    out = trace.read_ranges(_stretch(stall))
    assert out["stage_us"]["estimator"] == 8.0
    assert out["stage_us"]["control_solve"] == 55.0
    assert ["Command Buffer Full <- mul", 1, 8.0] in out["dropped"]


def test_ranges_holding_more_than_the_busy_time_are_refused():
    # two operations at once (two streams): the ranges hold their sum, the
    # busy time their union
    overlapping = [_host("aten::div", 170, 171, [("div", 8.0)])]
    prof = _stretch(overlapping)
    prof.events().append(_device("div", 1060, 1068))
    events = prof.events()
    with pytest.raises(ValueError, match="more than the stretch's busy"):
        trace.read_ranges(_prof(events))
