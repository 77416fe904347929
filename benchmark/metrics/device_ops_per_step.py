"""device_ops_per_step (ops/step): device operations (kernels, copies,
fills) in the profiled stretch of a sweep, over its steps."""
from benchmark.readers import ops_per_step


def read(rec):
    return ops_per_step(rec, "sweep")
