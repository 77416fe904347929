"""call_ms_p95 (ms): the 95th percentile over every call of the window,
from handing the fleet's state to ``step`` until u is on the host."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "serve" or not rec.get("latencies_ms"):
        return None
    return stats.percentile(rec["latencies_ms"], 95)
