"""Milliseconds per train step from the model's forward returning (the loss
starts) to the last gradient accumulated, with the checkpointed regions'
recompute inside it, on the card's clock (CUDA events); the mean over the
hooked half of a traced run."""


def read(rec):
    hooked = rec.get("hooked")
    if rec["kind"] != "train_batches" or not hooked or not hooked.get("backward_ms"):
        return None
    ms = hooked["backward_ms"]
    return sum(ms) / len(ms)
