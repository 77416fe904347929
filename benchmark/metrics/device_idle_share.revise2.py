"""device_idle_share.revise2 (%): the share of a sweep's profiled stretch (host
wall time, synchronized at both ends) in which no device operation ran:
1 - the union of the operations' intervals over the stretch.
The same reading as ``device_idle_share``, in the cells that report
``solves_per_s.revise2``, which has a bound of its own.
"""
from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "sweep")
