"""Device operations per pair launched while the host was inside the
program's `refine` span (at any depth), over the profiled calls of a
traced run: each operation put down to the span open at its runtime call,
matched by the profiler's correlation id, so an operation that a CUDA
graph replays counts under the span that replayed it. Nothing to read
where the program records no such span."""

from portbench.spans import traced


def read(rec):
    found = traced(rec, "refine")
    if found is None:
        return None
    spans, items = found
    return spans["ops_in"]["refine"] / items
