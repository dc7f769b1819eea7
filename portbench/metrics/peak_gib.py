"""``torch.cuda.max_memory_allocated()`` over the run's windows, after
``reset_peak_memory_stats()`` at their start, in GiB."""


def read(rec):
    peak = rec.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
