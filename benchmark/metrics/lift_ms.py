"""lift_ms (ms): device time a step of the operations launched under the
benchmark's ``lift`` range in the profiled stretch of a sweep."""
from benchmark.readers import stage_ms


def read(rec):
    return stage_ms(rec, "lift")
