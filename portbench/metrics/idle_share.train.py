"""The share of the traced calls' window in which no device operation ran,
in %: 1 - (union of the profiler's kernel and copy intervals) / window; on
N ranks the union is the mean over the ranks' cards, the window rank 0's."""


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train_batches" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
