"""Pairs whose disparity reached the host in the window over the window's
seconds (host clock; every call of the window, no chunking)."""


def read(rec):
    if rec["kind"] != "pairs":
        return None
    w = rec["window"]
    return w["items"] / w["seconds"]
