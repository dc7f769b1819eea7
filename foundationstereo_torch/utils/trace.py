"""Spans: named stretches of the program's work, recorded while a recorder
is open.

``span(name)`` marks a stage (the stages of ``FoundationStereo.forward``,
each collective of ``parallel/spatial.py``). With no recorder open it costs
one global read and returns a shared no-op context: no CUDA event, no
profiler annotation, no allocation.

Inside ``recording()`` every span records its name, its id, the id of the
span it opened in, its host start and end (``time.perf_counter_ns``), and
where CUDA is initialised when the recorder opens a pair of timing events
on the current stream (the card's clock; otherwise host time only).
While ``torch.profiler`` runs, each span also enters
``torch.profiler.record_function("fs.<name>")``, so that the stages lie on
the kernels' timeline.

Spans stay in memory. The recorder never synchronizes: ``summary()`` and
``ms()`` read the events, so the caller synchronizes first.
"""

from __future__ import annotations

import contextlib
import time

import torch

# The open recorder, or None (a list: the backward runs on the autograd
# engine's thread).
_RECORDER: list = [None]
_CLOSED = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "id", "parent", "host_ns", "events")

    def __init__(self, name: str, id: int, parent: int | None, events):
        self.name, self.id, self.parent = name, id, parent
        self.host_ns = [0, 0]
        self.events = events

    def host_ms(self) -> float:
        return (self.host_ns[1] - self.host_ns[0]) * 1e-6


class _Open:
    """The context of one recorded span."""

    __slots__ = ("rec", "span", "annotation")

    def __init__(self, rec: Recorder, span: Span):
        self.rec, self.span = rec, span

    def __enter__(self):
        self.rec._stack.append(self.span.id)
        # Annotated only while the profiler runs: nothing else reads the
        # annotation, and it costs host time at every span.
        self.annotation = (torch.profiler.record_function(f"fs.{self.span.name}")
                           if torch._C._autograd._profiler_enabled() else _CLOSED)
        self.annotation.__enter__()
        self.span.host_ns[0] = time.perf_counter_ns()
        if self.span.events:
            self.span.events[0].record()
        return self.span

    def __exit__(self, *exc):
        if self.span.events:
            self.span.events[1].record()
        self.span.host_ns[1] = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        self.rec._stack.pop()


class Recorder:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: list[Span] = []
        self._stack: list[int] = []

    def span(self, name: str) -> _Open:
        events = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  if self.cuda else None)
        s = Span(name, len(self.spans), self._stack[-1] if self._stack else None, events)
        self.spans.append(s)
        return _Open(self, s)

    def _device_intervals(self) -> list[tuple[float, float]] | None:
        """Each span's (start, end) in ms on the card's clock, from the first
        span's start; None without a card."""
        if not self.cuda or not self.spans:
            return None
        origin = self.spans[0].events[0]
        return [(origin.elapsed_time(s.events[0]), origin.elapsed_time(s.events[1]))
                for s in self.spans]

    def ms(self, name: str) -> float:
        """Summed milliseconds of the spans called ``name``: on the card's
        clock, or the host's without a card."""
        if self.cuda:
            return float(sum(s.events[0].elapsed_time(s.events[1])
                             for s in self.spans if s.name == name))
        return float(sum(s.host_ms() for s in self.spans if s.name == name))

    def summary(self) -> dict[str, dict]:
        """Per span name: ``count``, inclusive ``host_ms`` and ``device_ms``,
        and ``self_host_ms``/``self_device_ms``, each span's time less the
        part its child spans cover (the device's None without a card)."""
        parents = [s.parent for s in self.spans]
        host = [(s.host_ns[0] * 1e-6, s.host_ns[1] * 1e-6) for s in self.spans]
        device = self._device_intervals()
        self_host = self_times(parents, host)
        self_device = self_times(parents, device) if device else None
        out: dict[str, dict] = {}
        for i, s in enumerate(self.spans):
            row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                          "device_ms": None, "self_device_ms": None})
            row["count"] += 1
            row["host_ms"] += host[i][1] - host[i][0]
            row["self_host_ms"] += self_host[i]
            if device:
                row["device_ms"] = (row["device_ms"] or 0.0) + device[i][1] - device[i][0]
                row["self_device_ms"] = (row["self_device_ms"] or 0.0) + self_device[i]
        return out


def self_times(parents: list[int | None], intervals: list[tuple[float, float]]) -> list[float]:
    """Each interval's length less the part of it that its children's
    intervals (those whose parent it is) cover."""
    children: dict[int, list[tuple[float, float]]] = {}
    for i, p in enumerate(parents):
        if p is not None:
            children.setdefault(p, []).append(intervals[i])
    out = []
    for i, (a, b) in enumerate(intervals):
        covered, end = 0.0, a
        for c0, c1 in sorted(children.get(i, ())):
            c0, c1 = max(c0, end), min(c1, b)
            if c1 > c0:
                covered += c1 - c0
                end = c1
        out.append((b - a) - covered)
    return out


def span(name: str):
    """A stage of the program: recorded inside ``recording()``, a shared
    no-op context outside it."""
    rec = _RECORDER[0]
    return _CLOSED if rec is None else rec.span(name)


@contextlib.contextmanager
def recording():
    """Open a recorder for the block and yield it; the recorder open before
    it (if any) records again after it."""
    prev, _RECORDER[0] = _RECORDER[0], Recorder(torch.cuda.is_initialized())
    try:
        yield _RECORDER[0]
    finally:
        _RECORDER[0] = prev
