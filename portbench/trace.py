"""A few calls under ``torch.profiler``, reduced to what the per-layer
metrics and the ledger's breakdown read: each device operation's name and
interval, the union of those intervals (busy time), the longest idle gaps
labelled by what the host was running, and device time by name."""

from __future__ import annotations

import time

import torch


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps of [lo, hi) that no interval covers."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def host_label(host: list[tuple[str, float, float]], t: float) -> str:
    """The innermost host operation running at ``t`` (runtime calls aside)."""
    best = None
    for name, a, b in host:
        if a <= t < b and not name.startswith("cuda") and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "(no host operation: Python between calls)"


def collectives_s(by_name: dict[str, float]) -> float:
    """Device seconds of the NCCL kernels in ``device_time_by_name``: names
    that start with ``nccl``, but not the ``nccl:`` annotations that the
    profiler also draws on the device's timeline."""
    return sum(t for name, t in by_name.items()
               if name.startswith("nccl") and not name.startswith("nccl:"))


def reduce(device: list[tuple[str, float, float]], host: list[tuple[str, float, float]],
           lo: float, hi: float, top: int = 10) -> dict:
    """Times in seconds. ``device``/``host``: (name, start, end) on one clock;
    [lo, hi) the traced window."""
    spans = [(a, b) for _, a, b in device]
    by_name: dict[str, float] = {}
    launches: dict[str, int] = {}
    for name, a, b in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        launches[name] = launches.get(name, 0) + 1
    gaps = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": hi - lo,
        "busy_s": union_length(spans),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[host_label(host, (a + b) / 2), b - a] for a, b in gaps],
        "device_time_by_name": by_name,
        "launches_by_name": launches,
    }


def profile(fn, calls: int) -> dict:
    """``fn()`` ``calls`` times under the profiler, the window closed by a
    synchronize; the reduction of its events."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        (device if e.device_type == torch.autograd.DeviceType.CUDA else host).append(span)
    if not device:
        return {"window_s": wall, "busy_s": 0.0, "device_ops": [], "idle_gaps": [],
                "device_time_by_name": {}, "launches_by_name": {}}
    lo = min(a for _, a, _ in host + device)
    return reduce(device, host, lo, max(lo + wall, max(b for _, _, b in device)))
