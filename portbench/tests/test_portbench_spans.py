"""The program's spans as the benchmark would read them, on the CPU: the
attribution of idle time and device operations to spans on synthetic
intervals, and the seven span readers on synthetic records.

    python3 -m pytest portbench/tests -p no:cacheprovider -o addopts="" -q
"""

from __future__ import annotations

import pytest

from portbench import spans, spec

READERS = ["span_ms.features", "span_ms.filter", "span_ms.update", "span_ms.lookup",
           "idle_ms.refine", "idle_ms.outside_forward", "launches.refine"]


# -- attribution -----------------------------------------------------------------


def _request(t0: float) -> list[tuple[str, float, float]]:
    """One request's host spans from ``t0`` (a request of 10 s): forward
    [t0+1, t0+9), which holds refine [t0+5, t0+9) with lookup [t0+5, t0+6)
    and update [t0+6, t0+9)."""
    return [("forward", t0 + 1, t0 + 9), ("refine", t0 + 5, t0 + 9),
            ("lookup", t0 + 5, t0 + 6), ("update", t0 + 6, t0 + 9)]


def test_a_gap_straddling_two_spans_is_split_between_them():
    host = _request(0.0)
    # device busy [0, 5.5) and [7.5, 10): one gap [5.5, 7.5) across lookup and update
    device = [("k_a", 0.0, 5.5, 1), ("k_b", 7.5, 10.0, 2)]
    out = spans.attribute(device, [], host, 0.0, 10.0)
    assert out["idle_s"] == {"forward": 0.0, "refine": 0.0,
                             "lookup": pytest.approx(0.5), "update": pytest.approx(1.5)}
    assert out["idle_in_s"]["refine"] == out["idle_in_s"]["forward"] == pytest.approx(2.0)
    assert sum(out["idle_s"].values()) == pytest.approx(2.0)


def test_the_parts_sum_to_the_gaps_with_time_outside_every_span():
    host = _request(1.0) + _request(12.0)        # nothing open in [0, 2), [10, 13), [21, 30)
    device = [("k", 2.5, 3.0, 1), ("k", 7.0, 8.0, 2), ("k", 14.0, 20.0, 3)]
    out = spans.attribute(device, [], host, 0.0, 30.0)
    window_idle = 30.0 - (0.5 + 1.0 + 6.0)
    assert sum(out["idle_s"].values()) == pytest.approx(window_idle)
    assert out["idle_s"][spans.NO_SPAN] == pytest.approx(2.0 + 3.0 + 9.0)
    # forward open over [2, 10) and [13, 21): idle there is 8 - 1.5 + 8 - 6
    assert out["idle_in_s"]["forward"] == pytest.approx(8.5)
    outside = sum(out["idle_s"].values()) - out["idle_in_s"]["forward"]
    assert outside == pytest.approx(window_idle - 8.5)


def test_operations_go_to_the_span_open_at_their_launch():
    host = _request(0.0)
    runtime = [("cudaLaunchKernel", 2.0, 2.01, 11),     # forward, outside refine
               ("cudaLaunchKernel", 5.2, 5.21, 12),     # lookup
               ("cudaGraphLaunch", 7.0, 7.02, 13),      # update: a replay of three
               ("cudaMemcpyAsync", 9.5, 9.6, 14)]       # after forward
    device = [("conv", 2.1, 2.5, 11), ("disparity_lookup_kernel", 5.3, 5.4, 12),
              ("gemm", 7.1, 7.2, 13), ("gemm", 7.2, 7.3, 13), ("add", 9.2, 9.4, 13),
              ("Memcpy DtoH", 9.7, 9.9, 14), ("late", 10.5, 10.6, 99)]
    out = spans.attribute(device, runtime, host, 0.0, 11.0)
    assert out["ops"] == {"forward": 1, "refine": 0, "lookup": 1, "update": 3, spans.NO_SPAN: 2}
    assert out["ops_in"]["refine"] == 4 and out["ops_in"]["forward"] == 5
    assert out["ops_by_name"]["lookup"] == {"disparity_lookup_kernel": 1}
    assert out["ops_by_name"]["update"] == {"gemm": 2, "add": 1}
    assert out["unmatched"] == 1                 # "late": placed at its own start, outside
    assert out["ops_by_name"][spans.NO_SPAN] == {"Memcpy DtoH": 1, "late": 1}


# -- the readers ------------------------------------------------------------------


def _row(device_ms):
    return {"count": 32, "host_ms": 1.0, "self_host_ms": 1.0, "device_ms": device_ms,
            "self_device_ms": device_ms}


def _record(with_spans: bool = True, device: bool = True) -> dict:
    names = ("features", "filter", "update", "lookup")
    hooked = {"items": 4, "calls": 4,
              "spans": {n: _row(100.0 * (i + 1) if device else None) for i, n in enumerate(names)}}
    trace = {"items": 2, "calls": 2, "window_s": 2.0, "busy_s": 1.5,
             "spans": {"idle_s": {"refine": 0.0, "update": 0.2, "lookup": 0.1, "forward": 0.05,
                                  spans.NO_SPAN: 0.15},
                       "idle_in_s": {"refine": 0.3, "forward": 0.35},
                       "ops": {}, "ops_in": {"refine": 6000, "forward": 9000},
                       "ops_by_name": {}, "unmatched": 0}}
    if not with_spans:
        del hooked["spans"], trace["spans"]
    return {"kind": "pairs", "hooked": hooked, "trace": trace}


def test_each_reader_gives_its_value():
    want = {"span_ms.features": 25.0, "span_ms.filter": 50.0, "span_ms.update": 75.0,
            "span_ms.lookup": 100.0, "idle_ms.refine": 150.0,
            "idle_ms.outside_forward": 1e3 * (0.5 - 0.35) / 2, "launches.refine": 3000.0}
    rec = _record()
    assert set(want) == set(READERS)
    for name in READERS:
        assert spec.reader(name)(rec) == pytest.approx(want[name]), name


@pytest.mark.parametrize("rec, silent", [
    (_record(with_spans=False), READERS),
    (_record(device=False), READERS[:4]),
    ({"kind": "pairs", "window": {}}, READERS),
    (dict(_record(), kind="train_batches"), READERS)],
    ids=["parent program", "no card", "untraced", "training"])
def test_readers_read_nothing_without_spans(rec, silent):
    for name in silent:
        assert spec.reader(name)(rec) is None, name


def test_readers_read_nothing_where_the_span_is_missing():
    rec = _record()
    rec["hooked"]["spans"] = {}
    rec["trace"]["spans"] = spans.attribute([("k", 0.0, 1.0, 1)], [], [], 0.0, 2.0)
    for name in READERS:
        assert spec.reader(name)(rec) is None, name
