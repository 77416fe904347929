"""call_ms_p50 (ms): the median over every call of the window, from
handing the fleet's state to ``step`` until u is on the host."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "serve" or not rec.get("latencies_ms"):
        return None
    return stats.percentile(rec["latencies_ms"], 50)
