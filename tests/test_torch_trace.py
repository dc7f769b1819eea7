"""The span recorder (``utils/trace.py``) and the spans of the served path,
on the CPU at vits, max_disp 64, 64x96, 2 refinement steps.

* With no recorder open ``run_pair`` records nothing, and its disparity is
  bit for bit the one it gives with a recorder open; with no profiler
  running, an open recorder annotates nothing.
* Each ``run_pair`` under ``recording()`` gives the span tree of the
  model's forward: names, parents, a ``lookup`` and an ``update`` per
  step.
* Self time: a span's time less the part its children cover, on a
  hand-built tree.
* Under ``torch.profiler`` the spans are ``fs.*`` events.
* ``spatial.timed()``/``exchange_ms`` sum the ``exchange.<kind>`` spans of
  the collectives, on a one-rank ``gloo`` group.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from foundationstereo_torch.config import ModelConfig
from foundationstereo_torch.inference.demo import run_pair
from foundationstereo_torch.models.foundation_stereo import FoundationStereo
from foundationstereo_torch.parallel import spatial
from foundationstereo_torch.utils import trace

ITERS = 2
PAIR_SPANS = ["forward", "features", "filter", "refine"] + ["lookup", "update"] * ITERS
PARENTS = {"forward": None, "features": "forward", "filter": "forward", "refine": "forward",
           "lookup": "refine", "update": "refine"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this file: its tensors are small, and the
    suite runs several files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return FoundationStereo(ModelConfig(vit_size="vits", max_disp=64, mixed_precision=False),
                            device="cpu")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (64, 96, 3), dtype=np.uint8) for _ in range(2)]


def test_closed_recorder_records_nothing_and_changes_nothing(model, pair, monkeypatch):
    assert trace._RECORDER[0] is None
    assert trace.span("forward") is trace.span("lookup")
    with monkeypatch.context() as m:
        m.setattr(trace.Recorder, "span", lambda *a: pytest.fail("recorded with no recorder open"))
        closed = run_pair(model, *pair, iters=ITERS)
    with monkeypatch.context() as m, trace.recording() as rec:
        # open, but with no profiler running: no annotation
        m.setattr(torch.profiler, "record_function", lambda *a: pytest.fail("annotated"))
        opened = run_pair(model, *pair, iters=ITERS)
    assert len(rec.spans) == len(PAIR_SPANS)
    assert torch.equal(closed, opened)


def test_run_pair_gives_the_span_tree(model, pair):
    with trace.recording() as rec:
        run_pair(model, *pair, iters=ITERS)
        run_pair(model, *pair, iters=ITERS)
    assert trace._RECORDER[0] is None
    spans = rec.spans
    assert [s.name for s in spans] == PAIR_SPANS * 2
    assert [s.id for s in spans] == list(range(len(spans)))
    for s in spans:
        parent = None if s.parent is None else spans[s.parent].name
        assert parent == PARENTS[s.name], s.name
        assert s.events is None and 0 < s.host_ns[0] <= s.host_ns[1]
        if s.parent is not None:
            p = spans[s.parent]
            assert p.host_ns[0] <= s.host_ns[0] <= s.host_ns[1] <= p.host_ns[1]
    assert spans[len(PAIR_SPANS)].host_ns[0] >= spans[len(PAIR_SPANS) - 1].host_ns[1]
    summary = rec.summary()
    assert summary["lookup"]["count"] == summary["update"]["count"] == 2 * ITERS
    assert summary["forward"]["count"] == 2 and summary["forward"]["device_ms"] is None
    fwd = summary["forward"]
    children = sum(summary[n]["host_ms"] for n, p in PARENTS.items() if p == "forward")
    assert fwd["self_host_ms"] == pytest.approx(fwd["host_ms"] - children, abs=1e-6)
    assert rec.ms("lookup") == pytest.approx(summary["lookup"]["host_ms"])


def test_self_time_is_the_duration_less_the_childrens_cover():
    # 0: [0, 10) with children 1: [1, 4) and 2: [3, 6) (overlapping: the
    # union covers 5), 3: [8, 12) reaching past its parent (covers 2);
    # 4: [2, 3) is 1's child, not 0's.
    parents = [None, 0, 0, 0, 1]
    intervals = [(0.0, 10.0), (1.0, 4.0), (3.0, 6.0), (8.0, 12.0), (2.0, 3.0)]
    assert trace.self_times(parents, intervals) == pytest.approx([3.0, 2.0, 3.0, 4.0, 1.0])


def test_spans_are_profiler_events(model, pair):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.recording():
            run_pair(model, *pair, iters=ITERS)
        run_pair(model, *pair, iters=ITERS)              # closed: no annotation
    names = [e.name for e in prof.events() if e.name.startswith("fs.")]
    assert sorted(names) == sorted(f"fs.{n}" for n in PAIR_SPANS)


def test_exchange_ms_sums_the_collectives_spans(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", world_size=1, rank=0)
    try:
        buf = torch.ones(1024)
        with spatial.timed() as rec:
            with trace.span("outer"):
                spatial._all_reduce(buf, None)
                spatial._all_reduce(buf, None, "heads")
                spatial._all_reduce(buf, None, "heads")
        with spatial.timed() as empty:
            pass
    finally:
        dist.destroy_process_group()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("outer", None), ("exchange.partition", 0), ("exchange.heads", 0), ("exchange.heads", 0)]
    heads = [s.host_ms() for s in rec.spans if s.name == "exchange.heads"]
    assert spatial.exchange_ms(rec, "heads") == pytest.approx(sum(heads)) and min(heads) > 0
    assert spatial.exchange_ms(rec) == pytest.approx(rec.spans[1].host_ms())
    assert spatial.exchange_ms(empty, "heads") == 0.0
    assert torch.equal(buf, torch.ones(1024))
