"""Milliseconds per pair of the pyramid lookups: the program's `lookup`
spans (every call of the lookup, K2 with its host dispatch, 32 per pair),
on the card's clock (the recorder's CUDA events at the span's ends), summed
over the hooked half of a traced run, host gaps inside the span included.
Nothing to read where the program records no such span."""

from portbench.spans import hooked_ms


def read(rec):
    return hooked_ms(rec, "lookup")
