"""Milliseconds per train step of the collectives' kernels, on the card
whose collectives took longest: the device time of the NCCL kernels
(``trace.collectives_s``) over the profiled steps, per step, the largest
over the ranks, each of which profiled the same steps alike. A collective's
kernel runs until every rank has joined it, so the rank that reaches the
meetings first reads the wait for the slowest. No such kernel traced (one
rank): nothing to read."""

from portbench.trace import collectives_s


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "train_batches" or not trace:
        return None
    s = max(collectives_s(row["device_time_by_name"]) for row in trace.get("by_rank", [trace]))
    return 1e3 * s / trace["calls"] if s > 0 else None
