"""Milliseconds per pair of the cost filtering: the program's `filter` span
(`corr_stem`, `corr_feature_att`, `cost_agg`, `classifier`, the softmax and
the soft-argmin), on the card's clock (the recorder's CUDA events at the
span's ends), summed over the hooked half of a traced run, host gaps inside
the span included. Nothing to read where the program records no such
span."""

from portbench.spans import hooked_ms


def read(rec):
    return hooked_ms(rec, "filter")
