"""Milliseconds per pair in which the device was idle while the host was
inside the program's `refine` span (the 32 refinement steps and the
upsampling head, at any depth), over the profiled calls of a traced run:
the profiler's idle gaps split by the innermost `fs.*` span open on the
host. Nothing to read where the program records no such span."""

from portbench.spans import traced


def read(rec):
    found = traced(rec, "refine")
    if found is None:
        return None
    spans, items = found
    return 1e3 * spans["idle_in_s"]["refine"] / items
