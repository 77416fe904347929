"""peak_mem_gib.revise2 (GiB): ``torch.cuda.max_memory_allocated`` over a sweep's
window, the peak reset after set-up.
The same reading as ``peak_mem_gib``, in the cells that report
``solves_per_s.revise2``, which has a bound of its own.
"""


def read(rec):
    if rec.get("entry") != "sweep" or "window_peak_bytes" not in rec:
        return None
    return rec["window_peak_bytes"] / 2 ** 30
