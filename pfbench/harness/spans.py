"""Spans around the benchmark's own calls into each layer of the program.

On the card a span is a pair of CUDA events, read once the window has
closed; elsewhere (the CPU tests) it is the host clock. A span also names
the region for the profiler (`record_function`), so that a traced run's
idle gaps can say what the host was doing. Spans are off in a run that
measures the end-to-end metrics; `timing` turns the events off and
keeps the names, for the units the profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


class Spans:
    def __init__(self, device: torch.device, on: bool):
        self.device = torch.device(device)
        self.on = on
        self.timing = on
        self._events = defaultdict(list)
        self._host = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"pfbench.{name}"):
            if not self.timing:
                yield
            elif self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events[name].append((start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._host[name].append(1e3 * (time.perf_counter() - t0))

    def mark(self):
        """A point on the device's timeline (the host clock off the card)
        for `add`, or None when spans are off."""
        if not (self.on and self.timing):
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, name: str, start, end):
        """A span between two marks."""
        if start is None or end is None:
            return
        if self.device.type == "cuda":
            self._events[name].append((start, end))
        else:
            self._host[name].append(1e3 * (end - start))

    def clear(self):
        """Drop what set-up and warm-up recorded: the window's spans alone
        are read."""
        self._events.clear()
        self._host.clear()

    def ms(self) -> Dict[str, List[float]]:
        """Every span's milliseconds by name (waits for the device)."""
        if self._events:
            torch.cuda.synchronize(self.device)
        out = {k: list(v) for k, v in self._host.items()}
        for name, pairs in self._events.items():
            out.setdefault(name, []).extend(s.elapsed_time(e)
                                            for s, e in pairs)
        return out
