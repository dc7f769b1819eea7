"""Milliseconds per pair of the refinement's update: the program's `update`
spans (every call of `update_block`, 32 per pair), on the card's clock (the
recorder's CUDA events at the span's ends), summed over the hooked half of
a traced run, host gaps inside the span included. Nothing to read where
the program records no such span."""

from portbench.spans import hooked_ms


def read(rec):
    return hooked_ms(rec, "update")
