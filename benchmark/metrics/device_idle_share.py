"""device_idle_share (%): the share of a sweep's profiled stretch (host
wall time, synchronized at both ends) in which no device operation ran:
1 - the union of the operations' intervals over the stretch."""
from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "sweep")
