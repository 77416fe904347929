"""device_ops_per_call (ops/call): device operations in the profiled
stretch of a served fleet (the caller's plant step included), over its
calls."""
from benchmark.readers import ops_per_step


def read(rec):
    return ops_per_step(rec, "serve")
