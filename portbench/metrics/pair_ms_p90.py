"""The 90th percentile (linear between order statistics) of every call's
latency in the window: host arrays handed to ``run_pair`` to the disparity
on the host, in ms. One call is one pair at batch 1."""

import numpy as np


def read(rec):
    if rec["kind"] != "pairs":
        return None
    return float(np.percentile(np.asarray(rec["window"]["latencies_s"]) * 1e3, 90))
