"""Seconds from the process's start to the end of the warm-up: imports, CUDA
context, kernel build or load, weights, traffic, warm-up calls (host clock)."""


def read(rec):
    return rec["setup_s"]
