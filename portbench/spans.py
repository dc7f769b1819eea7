"""The program's spans under ``torch.profiler``: the device's idle time and
its operations put down to the stage the host was in.

The program (``foundationstereo_torch/utils/trace.py``) marks its stages as
spans; while its recorder is open each span is also a profiler annotation
``fs.<name>`` on the host's timeline. ``attribute`` splits every idle gap of
the traced window by the innermost ``fs.*`` span open on the host over that
stretch, and gives each device operation to the innermost span open when
its runtime call (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
or ``cudaGraphLaunch`` for every operation a graph replays) ran on the host,
matched by the profiler's correlation id.

``hooked_ms`` and ``traced`` are what the span metrics' readers read: the
recorder's ``summary()`` of the hooked half under ``record["hooked"]["spans"]``,
and ``attribute``'s result for the profiled calls under
``record["trace"]["spans"]``. Nothing here is written to disk.
"""

from __future__ import annotations

import bisect

from portbench.trace import idle_gaps

NO_SPAN = "(no span)"


def _segments(spans: list[tuple[str, float, float]]):
    """The timeline cut where a span opens or closes: (starts, chains), each
    chain the names of the spans open over that stretch, innermost first
    (empty where none is)."""
    marks = sorted([(a, 1, -b, i) for i, (_, a, b) in enumerate(spans)]
                   + [(b, 0, 0, i) for i, (_, a, b) in enumerate(spans)])
    starts, chains, open_ = [], [], []
    for t, opens, _, i in marks:
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        chain = tuple(spans[j][0] for j in reversed(open_))
        if starts and starts[-1] == t:
            chains[-1] = chain
        else:
            starts.append(t)
            chains.append(chain)
    return starts, chains


def attribute(device: list[tuple[str, float, float, int]],
              runtime: list[tuple[str, float, float, int]],
              spans: list[tuple[str, float, float]], lo: float, hi: float) -> dict:
    """Times in seconds, on one clock. ``device``: (name, start, end,
    correlation id) of each device operation; ``runtime``: the same of each
    runtime or driver call on the host; ``spans``: (name, start, end) of
    each ``fs.*`` span, the prefix taken off; [lo, hi) the traced window.

    Returns, per name of ``spans``: ``idle_s``, the idle seconds during
    which it was the innermost open span (``(no span)`` where none was),
    which sum to the window's idle time; ``idle_in_s``, those during which a span of that
    name was open at any depth; ``ops`` and ``ops_in``, device operations
    likewise by the span open at their launch; ``ops_by_name``, per
    innermost span the operations' counts by name; and ``unmatched``, the
    operations with no runtime call of their id (placed at their start)."""
    starts, chains = _segments(spans)

    def chain_at(t: float) -> tuple:
        k = bisect.bisect_right(starts, t) - 1
        return chains[k] if k >= 0 else ()

    names = {n for n, _, _ in spans}
    idle = dict.fromkeys(names, 0.0)
    idle_in = dict.fromkeys(names, 0.0)
    for a, b in idle_gaps([(s, e) for _, s, e, _ in device], lo, hi):
        k = bisect.bisect_right(starts, a) - 1      # the stretch that holds a
        t = a
        while t < b:
            end = min(starts[k + 1], b) if k + 1 < len(starts) else b
            chain = chains[k] if k >= 0 else ()
            inner = chain[0] if chain else NO_SPAN
            idle[inner] = idle.get(inner, 0.0) + (end - t)
            for name in set(chain):
                idle_in[name] = idle_in.get(name, 0.0) + (end - t)
            t, k = end, k + 1
    launched = {c: s for _, s, _, c in runtime if c}
    ops = dict.fromkeys(names, 0)
    ops_in = dict.fromkeys(names, 0)
    by_name: dict[str, dict[str, int]] = {}
    unmatched = 0
    for name, s, _, c in device:
        t = launched.get(c) if c else None
        if t is None:
            unmatched += 1
            t = s
        chain = chain_at(t)
        inner = chain[0] if chain else NO_SPAN
        ops[inner] = ops.get(inner, 0) + 1
        row = by_name.setdefault(inner, {})
        row[name] = row.get(name, 0) + 1
        for n in set(chain):
            ops_in[n] = ops_in.get(n, 0) + 1
    return {"idle_s": idle, "idle_in_s": idle_in, "ops": ops, "ops_in": ops_in,
            "ops_by_name": by_name, "unmatched": unmatched}


def hooked_ms(rec: dict, name: str) -> float | None:
    """Device milliseconds per item of the spans called ``name`` over the
    hooked half of a traced pairs run; None where it recorded none."""
    hooked = rec.get("hooked")
    if rec["kind"] != "pairs" or not hooked:
        return None
    row = (hooked.get("spans") or {}).get(name)
    if not row or row["device_ms"] is None:
        return None
    return row["device_ms"] / hooked["items"]


def traced(rec: dict, name: str) -> tuple[dict, int] | None:
    """The profiled calls' attribution and their items, where a traced
    pairs run has one in which a span called ``name`` was open."""
    trace = rec.get("trace")
    if rec["kind"] != "pairs" or not trace or not trace.get("spans"):
        return None
    if name not in trace["spans"]["idle_in_s"]:
        return None
    return trace["spans"], trace["items"]
