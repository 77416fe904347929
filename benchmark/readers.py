"""Helpers of the metric readers in ``benchmark/metrics/``: each reader's
``read(rec)`` takes one run's record and returns its number, or None where
the record holds nothing for it (another entry, or no trace)."""
from __future__ import annotations

from typing import Optional

from . import roofline


def traced(rec: dict, entry: str) -> Optional[dict]:
    """The profiled stretch of a run of ``entry`` ('sweep' or 'serve')."""
    if rec.get("entry") != entry or "profile" not in rec:
        return None
    return rec["profile"]


def stage_ms(rec: dict, stage: str) -> Optional[float]:
    """Device milliseconds a step under a range of a sweep's stretch."""
    prof = traced(rec, "sweep")
    if prof is None or stage not in prof["stage_us"]:
        return None
    return prof["stage_us"][stage] / rec["steps"] / 1e3


def idle_share(rec: dict, entry: str) -> Optional[float]:
    """Percent of the stretch's wall time in which no device operation ran."""
    prof = traced(rec, entry)
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_us"] / prof["window_us"])


def ops_per_step(rec: dict, entry: str) -> Optional[float]:
    prof = traced(rec, entry)
    return None if prof is None else prof["device_ops"] / rec["steps"]


def roofline_share(rec: dict, stage: str, work) -> Optional[float]:
    """Percent: the least time on an H100 SXM for the stage's work
    ``(operations, bytes)`` over its device time a step."""
    ms = stage_ms(rec, stage)
    if not ms:
        return None
    least = roofline.least_seconds(*work, rec["itemsize"])
    return 100.0 * least / (ms * 1e-3)
