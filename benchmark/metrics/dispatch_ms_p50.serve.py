"""dispatch_ms_p50.serve (ms): the median over the calls outside the
profiled stretch of the host's time in ``BatchedController.step``, until
it returns and before u is read back."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "serve" or not rec.get("dispatch_ms"):
        return None
    return stats.percentile(rec["dispatch_ms"], 50)
