"""device_idle_share.serve (%): the share of a served fleet's profiled
stretch in which no device operation ran."""
from benchmark.readers import idle_share


def read(rec):
    return idle_share(rec, "serve")
