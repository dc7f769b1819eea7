"""Milliseconds per pair of the refinement: every call of `update_block` (32 per pair), on the card's clock: CUDA events at
forward pre- and post-hooks on those top-level modules, summed over the
hooked half of a traced run (host gaps inside a call included)."""

MODULES = ['update_block']


def read(rec):
    hooked = rec.get("hooked")
    if rec["kind"] != "pairs" or not hooked or not hooked.get("module_ms"):
        return None
    ms = hooked["module_ms"]
    if not any(n in ms for n in MODULES):
        return None
    return sum(ms.get(n, 0.0) for n in MODULES) / hooked["items"]
