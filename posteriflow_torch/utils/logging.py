"""Logging and tracing for the port.

Port of posteriflow_tpu/utils/logging.py: setup_logging and peak_rss_mb.
The JAX package also silences absl, orbax and jax there; the port imports
none of them. `torch_trace` is jax_trace's counterpart: a torch.profiler
trace of a region, written as a Chrome trace.

The span recorder (`span`, `count`, `snapshot`, `reset`, `paused`) is
the port's counterpart of JAX's TimingLogger: named regions inside the
program (`pf.encoder`, `pf.flow.sample`, `pf.train.step`, ...), live only
while a torch profiler records in this process and the thread has not
paused it. A live span is a
`record_function` range, so it lands in the profiler's trace on the
kernels' clock, and a record of its host time, its device time (a pair of
CUDA events) and the counts made inside it, which `snapshot()` totals by
name.
"""

from __future__ import annotations

import contextlib
import logging
import resource
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    """Root logging at `level` with a timestamped format; returns the
    "posteriflow" logger. force=True: a root logger configured earlier
    would make a plain basicConfig a silent no-op."""
    logging.basicConfig(
        level=level, force=True,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    return logging.getLogger("posteriflow")


def peak_rss_mb() -> float:
    """Peak resident set size of this process [MB] (ru_maxrss is in KiB
    on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class UserScopeProfile:
    """A torch profiler session of `activities` that records, of the
    host's side, the record_function ranges alone (the pf.* spans) and no
    operator: torch.profiler.profile has no such setting, so this takes
    its private entry points (torch.autograd.profiler). The interface is
    profile's: a context manager, then export_chrome_trace(path).

    Pinned to torch 2.11 and 2.13, whose private entry points match:
    ProfilerConfig's seven positional arguments, _prepare_profiler,
    _run_on_profiler_start, _enable_profiler (its third argument the
    record scopes), _disable_profiler and _run_on_profiler_stop. Check
    them on a torch upgrade: the user-scope session's test in
    tests/test_torch_spans.py fails on the CPU where they changed."""

    def __init__(self, activities):
        self.activities = set(activities)
        self._result = None

    def __enter__(self):
        from torch._C._profiler import (ProfilerState, RecordScope,
                                        _ExperimentalConfig)
        cfg = _autograd_profiler.ProfilerConfig(
            ProfilerState.KINETO, False, False, False, False, False,
            _ExperimentalConfig())
        _autograd_profiler._prepare_profiler(cfg, self.activities)
        _autograd_profiler._run_on_profiler_start()
        _autograd_profiler._enable_profiler(cfg, self.activities,
                                            {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc):
        self._result = _autograd_profiler._disable_profiler()
        _autograd_profiler._run_on_profiler_stop()
        return False

    def export_chrome_trace(self, path: str):
        self._result.save(path)


class Trace:
    """A running torch profiler trace that `stop()` ends and writes to
    <logdir>/trace.json; stopping again does nothing. For a run on a card
    it records the card's activity (kernels, copies, launches) and the
    pf.* spans (UserScopeProfile), for a run on the CPU the host's
    operators: a trace of every host operator of a training epoch on the
    card (~50,000 with their launches) would run to hundreds of MB."""

    def __init__(self, logdir, device="cuda"):
        from torch.profiler import ProfilerActivity, profile
        self.path = Path(logdir) / "trace.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if torch.device(device).type == "cuda":
            self._prof = UserScopeProfile([ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
        else:
            self._prof = profile(activities=[ProfilerActivity.CPU])
        self._prof.__enter__()

    def stop(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(self.path))


@contextlib.contextmanager
def torch_trace(logdir: Optional[str], device="cuda"):
    """A torch.profiler trace of the work of a run on `device` around a
    region, written to <logdir>/trace.json when the region ends or `stop()`
    is called on the Trace it yields; with logdir None, a no-op that yields
    None."""
    if logdir is None:
        yield None
        return
    trace = Trace(logdir, device)
    try:
        yield trace
    finally:
        trace.stop()


# ── the span recorder ─────────────────────────────────────────────────────

# closed spans kept before those whose end event has completed are folded
# into the totals: more than a traced unit holds, so that the folding (an
# event query and an elapsed time a span) waits for snapshot()
PENDING_MAX = 4096


class _Off:
    """The span of a recorder that is off: enters and leaves, nothing
    else."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A live span: a record_function range, and its record once closed
    (name, parent's name, unit, host clock, CUDA events, counts)."""
    __slots__ = ("rec", "name", "up", "parent", "unit", "owns_unit", "rf",
                 "stream", "ev0", "ev1", "t0", "t1", "child_s", "counts")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name
        self.child_s = 0.0
        self.counts = None
        self.ev0 = self.ev1 = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.up = stack[-1] if stack else None
        self.owns_unit = False
        if self.up is not None:
            self.parent, self.unit = self.up.name, self.up.unit
        else:
            self.parent = None
            with rec._lock:
                # alone on its thread (autograd's, running a backward
                # inside another thread's step): the live unit, if any
                self.unit = rec._live_unit
                if self.unit is None:
                    rec._next_unit += 1
                    self.unit = rec._live_unit = rec._next_unit
                    self.owns_unit = True
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
            self.stream = None
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        self.rf.__exit__(*exc)
        self.rf = None
        if self.up is not None:
            self.up.child_s += self.t1 - self.t0
            self.up = None
        self.rec._close(self)
        return False


class _Totals:
    """A span name's totals over its folded records."""
    __slots__ = ("calls", "units", "last_unit", "host_s", "self_s",
                 "device_ms", "timed", "counts", "parents")

    def __init__(self):
        self.calls = self.units = self.timed = 0
        self.last_unit = None
        self.host_s = self.self_s = self.device_ms = 0.0
        self.counts: Dict[str, float] = {}
        self.parents: Dict[Optional[str], int] = {}

    def add(self, s: _Span):
        self.calls += 1
        if s.unit != self.last_unit:
            self.units += 1
            self.last_unit = s.unit
        host = s.t1 - s.t0
        self.host_s += host
        self.self_s += host - s.child_s
        if s.ev1 is not None:
            self.device_ms += s.ev0.elapsed_time(s.ev1)
            self.timed += 1
        for k, v in (s.counts or {}).items():
            self.counts[k] = self.counts.get(k, 0) + v
        self.parents[s.parent] = self.parents.get(s.parent, 0) + 1

    def as_dict(self) -> dict:
        return {"calls": self.calls, "units": self.units,
                "host_ms": 1e3 * self.host_s,
                "self_host_ms": 1e3 * self.self_s,
                "device_ms": self.device_ms if self.timed else None,
                "counts": dict(self.counts),
                "parents": dict(self.parents)}


class SpanRecorder:
    """Spans and counts by name, live only while a torch profiler records.

    A span records its name, its parent (the innermost live span on its
    own thread: autograd runs a backward on a thread of its own), its
    unit (the outermost live span's: one request, one step), its host
    clock and, with CUDA initialised, a pair of timing events on the
    current stream. Closed records are folded into per-name totals once
    PENDING_MAX are pending, those whose end event has completed (no
    synchronisation), so memory stays bounded."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending = []
        self._totals: Dict[str, _Totals] = {}
        self._next_unit = 0
        self._live_unit = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A context manager around the region `name` (pf.*): live while
        a torch profiler records, else one flag check and an empty
        context manager."""
        if (not _autograd_profiler._is_profiler_enabled
                or getattr(self._local, "paused", False)):
            return _OFF
        return _Span(self, name)

    def count(self, key: str, n: float = 1):
        """Add n to `key` in the innermost live span of this thread."""
        if (not _autograd_profiler._is_profiler_enabled
                or getattr(self._local, "paused", False)):
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[key] = top.counts.get(key, 0) + n

    @contextlib.contextmanager
    def paused(self):
        """No span opens and nothing is counted on this thread inside: for
        a CUDA graph's capture, which cannot hold a span's timing
        events."""
        was = getattr(self._local, "paused", False)
        self._local.paused = True
        try:
            yield
        finally:
            self._local.paused = was

    def _close(self, s: _Span):
        with self._lock:
            if s.owns_unit:
                self._live_unit = None
            self._pending.append(s)
            if len(self._pending) >= PENDING_MAX:
                self._fold(done_only=True)

    def _fold(self, done_only: bool):
        """Fold pending records, in order, into the totals: with
        done_only, up to the first whose end event has not completed."""
        n = 0
        for s in self._pending:
            if done_only and s.ev1 is not None and not s.ev1.query():
                break
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = _Totals()
            t.add(s)
            n += 1
        del self._pending[:n]

    def snapshot(self) -> Dict[str, dict]:
        """{name: calls, units, host_ms, self_host_ms (host_ms less what
        its children cover), device_ms (None without CUDA events), counts,
        parents ({parent name or None: calls})}, synchronising once."""
        with self._lock:
            timed = any(s.ev1 is not None for s in self._pending)
        if timed:
            torch.cuda.synchronize()
        with self._lock:
            self._fold(done_only=False)
            return {k: t.as_dict() for k, t in self._totals.items()}

    def reset(self):
        """Drop every record and total."""
        with self._lock:
            self._pending.clear()
            self._totals.clear()


RECORDER = SpanRecorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset
paused = RECORDER.paused


def count_h2d(host, device) -> None:
    """Count a copy of `host` (a CPU tensor or an array) from pageable
    memory to the CUDA device `device` in the innermost live span:
    h2d_pageable 1 and h2d_pageable_bytes its bytes. Such a copy waits for
    the stream before it starts, so it can hold the host behind the
    device."""
    if (not _autograd_profiler._is_profiler_enabled
            or torch.device(device).type != "cuda"):
        return
    if isinstance(host, torch.Tensor):
        if host.device.type != "cpu" or host.is_pinned():
            return
        nbytes = host.numel() * host.element_size()
    else:
        nbytes = np.asarray(host).nbytes
    count("h2d_pageable", 1)
    count("h2d_pageable_bytes", nbytes)
