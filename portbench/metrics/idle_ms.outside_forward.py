"""Milliseconds per pair in which the device was idle while no `forward`
span of the program was open on the host (`run_pair`'s own work around
the model's forward and the client between requests), over the profiled
calls of a traced run: the profiler's idle time less the part spent inside
`forward`. Nothing to read where the program records no such span."""

from portbench.spans import traced


def read(rec):
    found = traced(rec, "forward")
    if found is None:
        return None
    spans, items = found
    return 1e3 * (sum(spans["idle_s"].values()) - spans["idle_in_s"]["forward"]) / items
