"""device_ops_per_step.revise2 (ops/step): device operations (kernels, copies,
fills) in the profiled stretch of a sweep, over its steps.
The same reading as ``device_ops_per_step``, in the cells that report
``solves_per_s.revise2``, which has a bound of its own.
"""
from benchmark.readers import ops_per_step


def read(rec):
    return ops_per_step(rec, "sweep")
