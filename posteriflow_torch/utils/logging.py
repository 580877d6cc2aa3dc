"""Logging, stage timing and tracing for the port's tools.

Port of posteriflow_tpu/utils/logging.py: setup_logging, TimingLogger (a
stage timer collecting seconds into a dict) and peak_rss_mb. The JAX
package also silences absl, orbax and jax there; the port imports none of
them. `torch_trace` is jax_trace's counterpart: a torch.profiler trace of
a region, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import resource
import time
from pathlib import Path
from typing import Optional


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    """Root logging at `level` with a timestamped format; returns the
    "posteriflow" logger. force=True: a root logger configured earlier
    would make a plain basicConfig a silent no-op."""
    logging.basicConfig(
        level=level, force=True,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    return logging.getLogger("posteriflow")


class TimingLogger:
    """Context-manager stage timer: `with timer.stage(name):` adds the
    stage's wall seconds to timings[name] (and logs them, given a
    logger)."""

    def __init__(self, log: Optional[logging.Logger] = None):
        self.timings: dict[str, float] = {}
        self.log = log

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            if self.log:
                self.log.info("%s: %.3fs", name, dt)


def peak_rss_mb() -> float:
    """Peak resident set size of this process [MB] (ru_maxrss is in KiB
    on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Trace:
    """A running torch.profiler trace that `stop()` ends and writes to
    <logdir>/trace.json; stopping again does nothing. For a run on a card
    it records the card's activity (kernels, copies), for a run on the CPU
    the host's operators: a host trace of a training epoch on the card
    (~50,000 operators with their launches) would run to hundreds of MB."""

    def __init__(self, logdir, device="cuda"):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.path = Path(logdir) / "trace.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.device(device).type == "cuda"
            else ProfilerActivity.CPU])
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
