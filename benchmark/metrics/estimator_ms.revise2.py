"""estimator_ms.revise2 (ms): device time a step of the operations launched under the
benchmark's ``estimator`` range in the profiled stretch of a sweep.
The same reading as ``estimator_ms``, in the cells that report
``solves_per_s.revise2``, which has a bound of its own.
"""
from benchmark.readers import stage_ms


def read(rec):
    return stage_ms(rec, "estimator")
