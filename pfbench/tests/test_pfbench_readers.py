"""The arithmetic of the readers that per-layer metrics share."""

from __future__ import annotations

import pytest

from pfbench.harness import readers
from pfbench.harness.trace import TraceSummary


def _run(window_s, units, busy_s, traced_units, traced_window_s):
    trace = TraceSummary(units=traced_units, window_s=traced_window_s,
                         kernels=[("k", 0.0, 1.0)], busy_s=busy_s + 0.5,
                         device_busy_s=busy_s)
    return readers.RunData(cell="c", setup_s=1.0, window_s=window_s,
                           units=units, totals={}, latencies_s=[],
                           trace=trace)


def test_idle_share_divides_by_the_untraced_unit():
    # 10 units in 1 s untraced: 100 ms a unit; 4 traced units busy 240 ms
    # in all (60 ms a unit) besides pageable copies, however long the
    # profiler made the traced window and those copies take
    run = _run(1.0, 10, 0.24, 4, 0.9)
    assert readers.idle_pct(run) == pytest.approx(40.0)


def test_idle_share_needs_a_trace_with_kernels():
    run = _run(1.0, 10, 0.24, 4, 0.9)
    run.trace.kernels = []
    assert readers.idle_pct(run) is None
    run.trace = None
    assert readers.idle_pct(run) is None


def test_spans_read_the_window_alone():
    """What set-up and warm-up record is dropped before the window."""
    from pfbench.harness.spans import Spans
    spans = Spans("cpu", on=True)
    with spans.span("encode"):
        pass
    spans.clear()
    assert spans.ms() == {}
    with spans.span("encode"):
        pass
    assert len(spans.ms()["encode"]) == 1


def test_pageable_copies_are_not_device_work():
    from pfbench.harness.trace import summarize
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 20, "dur": 30,
           "name": "Memcpy HtoD (Pageable -> Device)"},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 5,
           "name": "Memcpy DtoH (Device -> Pinned)"}]
    t = summarize(ev, 1, 1e-4)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.device_busy_s == pytest.approx(15e-6)
