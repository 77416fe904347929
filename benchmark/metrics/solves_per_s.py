"""solves_per_s (solves/s): scenario control steps completed in the
window over the window's whole wall time, episode boundaries included."""
from benchmark import stats


def read(rec):
    if rec.get("entry") != "sweep" or "solves" not in rec:
        return None
    return stats.rate(rec["solves"], rec["window_s"])
