"""The ViT attention's share of its roofline, in %: the least time of the
attention calls traced (the larger of their operations at 989 TF/s and
their bytes at 3.35 TB/s, counted from the attention's shape:
4 B H N^2 d operations, q, k, v and the output once in bf16) over the
device time of the kernels whose names match ``PATTERN``.

A call is counted once however many launches implement it; where fewer
matching launches than calls are traced, only as many calls are counted.
No match: nothing to read."""

import re

from portbench import counting
from portbench.reference.vit import VIT_CONFIGS

PATTERN = re.compile(r"flash_fwd")


def read(rec):
    trace = rec.get("trace")
    if rec["kind"] != "pairs" or not trace:
        return None
    times = [(n, s) for n, s in trace["device_time_by_name"].items() if PATTERN.search(n)]
    launches = trace.get("launches_by_name", {})
    n_matched = sum(launches.get(n, 0) for n, _ in times)
    device_s = sum(s for _, s in times)
    if not times or device_s <= 0:
        return None
    vit = VIT_CONFIGS[rec["config"]["vit_size"]]
    shape = rec["shape"]
    h = -(-shape["height"] // 32) * 32
    w = -(-shape["width"] // 32) * 32
    tokens = counting.vit_tokens(h, w)
    calls = trace["calls"] * vit["depth"]
    if n_matched:
        calls = min(calls, n_matched)
    bound = counting.attention_bound_s(2 * shape["batch"], vit["num_heads"], tokens,
                                       vit["embed_dim"] // vit["num_heads"])
    return 100.0 * calls * bound / device_s
