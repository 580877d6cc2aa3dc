"""What the per-layer and end-to-end readers read, and the arithmetic they
share. A reader in pfbench/metrics/ is `read(run) -> float or None`; None
leaves its metric out of the run's line."""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from pfbench.harness import peaks
from pfbench.harness.trace import TraceSummary


@dataclass
class RunData:
    cell: str
    setup_s: float
    window_s: float                      # the measured window, host clock
    units: int                           # units of work completed in it
    totals: Dict[str, float]             # e.g. draws, events, posteriors
    latencies_s: List[float]             # one a request (closed loop)
    spans: Dict[str, List[float]] = field(default_factory=dict)   # ms
    counts: Dict[str, float] = field(default_factory=dict)  # a unit's
    trace: Optional[TraceSummary] = None


def rate(run: RunData, key: str) -> Optional[float]:
    """Every `key` completed in the window over the window."""
    if key not in run.totals or run.window_s <= 0:
        return None
    return run.totals[key] / run.window_s


def percentile_ms(run: RunData, q: float) -> Optional[float]:
    """The q-th percentile (linear between ranks) of every request's
    latency in the window, in ms."""
    if not run.latencies_s:
        return None
    xs = sorted(run.latencies_s)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return 1e3 * (xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def mean_span_ms(run: RunData, name: str) -> Optional[float]:
    xs = run.spans.get(name)
    return statistics.fmean(xs) if xs else None


def roofline_pct(run: RunData, bytes_keys, *kernel_names) -> Optional[float]:
    """The byte bound of the traced units' spline work at the HBM peak
    over the device time of the kernels named, in %."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(*kernel_names)
    nbytes = sum(run.counts.get(k, 0.0) for k in bytes_keys)
    if launches == 0 or seconds <= 0 or nbytes <= 0:
        return None
    bound = run.trace.units * nbytes / peaks.HBM_BYTES
    return 100.0 * bound / seconds


def mfu_pct(run: RunData) -> Optional[float]:
    """Matrix-product FLOPs of the window's units at the configuration's
    shapes over the window at the dense bf16 peak, in %."""
    flops = run.counts.get("flops")
    if not flops or run.window_s <= 0 or run.units == 0:
        return None
    return 100.0 * run.units * flops / (run.window_s * peaks.BF16_FLOPS)


def idle_pct(run: RunData) -> Optional[float]:
    """The share of a unit's time in which the device ran nothing, in %:
    1 − the device's busy time a traced unit over the time a unit of the
    untraced window took on the host clock. Busy is the union of kernels,
    fills and copies in the trace, less the copies from or to pageable
    host memory: the host stages those through a bounce buffer at its own
    pace, and the profiler slows it. The traced window's own length is not
    the divisor: the profiler slows the host's dispatch while it records,
    which would read as idle."""
    t = run.trace
    if t is None or t.units == 0 or not t.kernels or run.units == 0 \
            or run.window_s <= 0:
        return None
    busy = t.device_busy_s / t.units
    return 100.0 * (1.0 - busy / (run.window_s / run.units))
