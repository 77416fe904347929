"""solves_per_s.revise2 (solves/s): scenario control steps completed in the
window over the window's whole wall time, episode boundaries included.
The same reading as ``solves_per_s``, in the cells that report
``solves_per_s.revise2``, which has a bound of its own.
"""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "sweep" or "solves" not in rec:
        return None
    return stats.rate(rec["solves"], rec["window_s"])
