"""peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated`` over a sweep's
window, the peak reset after set-up."""


def read(rec):
    if rec.get("entry") != "sweep" or "window_peak_bytes" not in rec:
        return None
    return rec["window_peak_bytes"] / 2 ** 30
