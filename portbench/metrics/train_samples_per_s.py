"""Samples of the train steps completed in the window (each ended by a
synchronize) over the window's seconds (host clock)."""


def read(rec):
    if rec["kind"] != "train_batches":
        return None
    w = rec["window"]
    return w["items"] / w["seconds"]
