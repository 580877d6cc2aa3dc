"""One run of one cell: set-up, the measured window, the traced units, the
check against the plain reference, and the contract's result line.

A driver (pfbench/drivers/<name>.py) defines `Driver(cell, seed, device,
spans)` with:

    closed_loop    True if run_unit returns with its outputs on the host
                   (each unit is then a request with a latency)
    trace_units    how many units a traced run profiles after the window
    setup()        load the program, make the inputs, warm up; returns
                   the index of the first unit the window runs
    run_unit(i)    unit i of the traffic -> {"draws": n, ...}
    sync()         wait for the device
    failed()       units of the window whose outputs were not finite
    counts()       a unit's FLOPs and spline bytes (pfbench/counts)
    after_window() optional: program work that the check needs once the
                   window and the trace are over and the peak is read
    release()      drop the program's state before the reference runs
    check()        [Check]: each number compared, with its limit
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

from pfbench.harness import registry, trace
from pfbench.harness.readers import RunData
from pfbench.harness.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "posteriflow_tpu")


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run may not load, compared
    whole (posteriflow_torch is not posteriflow_tpu)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi prints them."""
    out = {"kind": torch.cuda.get_device_name(device)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        line = res.stdout.strip().splitlines()[device.index or 0]
        out["power_limit_w"] = float(line.rsplit(",", 1)[1])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float):
    """-> (the result dict, its checks); t0 is the process's start on the
    host clock, from which set-up is counted."""
    device = torch.device(device)
    spans = Spans(device, on=traced)
    drv = registry.driver_module(cell.driver).Driver(cell, seed, device,
                                                     spans)
    first = drv.setup()
    drv.sync()
    setup_s = time.perf_counter() - t0
    spans.clear()

    totals, latencies = defaultdict(float), []
    i = first
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        for k, v in drv.run_unit(i).items():
            totals[k] += v
        b = time.perf_counter()
        if drv.closed_loop:
            latencies.append(b - a)
        i += 1
        if b - start >= seconds:
            break
    drv.sync()
    window_s = time.perf_counter() - start
    units = i - first

    summary: Optional[trace.TraceSummary] = None
    if traced:
        spans_ms = spans.ms()
        spans.timing = False
        summary = trace.profile(drv.run_unit, i, drv.trace_units, device)
    else:
        spans_ms = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": cell.chips}
    if device.type == "cuda":
        dev.update(card(device))
        dev["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in range(cell.chips))
    else:
        dev.update(kind=device.type, memory_peak_bytes=0)
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    failed = drv.failed()
    if hasattr(drv, "after_window"):
        drv.after_window()
    run = RunData(cell=cell.name, setup_s=setup_s, window_s=window_s,
                  units=units, totals=dict(totals), latencies_s=latencies,
                  spans=spans_ms, counts=drv.counts(), trace=summary)
    drv.release()
    checks = drv.check()

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in registry.metrics_for(cell.name, kind):
        value = registry.reader(m.name).read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {"correct": failed == 0 and all(c.ok for c in checks),
              "attempted": units, "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks
