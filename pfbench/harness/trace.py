"""The device's side of a traced run, from torch.profiler's trace.

`profile` runs a few units of work under the profiler, writes the Chrome
trace under the temporary directory, reads it back and deletes it. From
the trace it keeps what the per-layer readers need: each kernel's name,
start and length; the union of the device's busy intervals (kernels,
copies, fills), and that union without the copies from or to pageable
host memory, which the host paces; the traced window's length on the host
clock; the device
operations that took the most time; and the idle gaps between busy
intervals, named by the innermost host operation or span running at the
gap's middle.

A session that holds no kernel is tried once more; a second empty one
raises EmptyTrace: no device number is then reported in its place.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Tuple

import torch

BUSY_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
TOP = 10


class EmptyTrace(RuntimeError):
    """Two profiler sessions in a row held no kernel."""


@dataclass
class TraceSummary:
    units: int                                   # units of work traced
    window_s: float                              # host clock over them
    kernels: List[Tuple[str, float, float]]      # (name, start_us, dur_us)
    busy_s: float                                # union of busy intervals
    device_busy_s: float = 0.0   # the same without pageable host copies
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, *substrings: str) -> Tuple[float, int]:
        """(total seconds, launches) of the kernels whose name holds any
        of `substrings`."""
        hits = [d for n, _, d in self.kernels
                if any(s in n for s in substrings)]
        return 1e-6 * sum(hits), len(hits)


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _doing(host, starts, marks, t: float) -> str:
    """The innermost host operation running at time t (the latest to
    start among the 400 that started last before t), else the span."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(host[max(0, i - 400):i]):
        if e >= t:
            return name
    for s, e, name in reversed(marks):
        if s <= t <= e:
            return name
    return "nothing traced"


def summarize(events: list, units: int, window_s: float) -> TraceSummary:
    """A Chrome trace's events -> TraceSummary."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [(e["name"], float(e["ts"]), float(e["dur"]))
               for e in spans if e.get("cat") == "kernel"]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in spans if e.get("cat") in BUSY_CATS])
    device_busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                          for e in spans if e.get("cat") in BUSY_CATS
                          and "Pageable" not in e["name"]])
    by_name = defaultdict(float)
    for e in spans:
        if e.get("cat") in BUSY_CATS:
            by_name[e["name"][:160]] += 1e-6 * float(e["dur"])
    device_ops = sorted(([k, v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:TOP]

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in spans if e.get("cat") in HOST_CATS)
    marks = [h for h in host if h[2].startswith("pfbench.")]
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        gaps[_doing(host, starts, marks, 0.5 * (end + nxt))[:160]] += (
            1e-6 * (nxt - end))
    idle_gaps = sorted(([k, v] for k, v in gaps.items()),
                       key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(units=units, window_s=window_s, kernels=kernels,
                        busy_s=1e-6 * sum(e - s for s, e in busy),
                        device_busy_s=1e-6 * sum(e - s
                                                 for s, e in device_busy),
                        device_ops=device_ops, idle_gaps=idle_gaps)


def _session(run_unit: Callable[[int], object], first: int, units: int,
             device: torch.device) -> TraceSummary:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(prefix="pfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        with profile(activities=acts, record_shapes=False,
                     with_stack=False) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + units):
                run_unit(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    finally:
        Path(path).unlink(missing_ok=True)
    return summarize(events, units, window_s)


def profile(run_unit: Callable[[int], object], first: int, units: int,
            device: torch.device) -> TraceSummary:
    """`units` units (indices from `first`) under the profiler."""
    device = torch.device(device)
    summary = _session(run_unit, first, units, device)
    if summary.kernels:
        return summary
    summary = _session(run_unit, first + units, units, device)
    if not summary.kernels:
        raise EmptyTrace("two profiler sessions held no kernel")
    return summary

