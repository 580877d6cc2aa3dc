"""Shared pieces of the benchmark's tests: cells cut to a size that the
CPU runs in a second (the code paths and the model's widths unchanged),
and one run of a cell on the CPU through the harness."""

from __future__ import annotations

import dataclasses
import time

import torch

from pfbench.harness import registry, window

TINY = {
    "npe_r7.sample": dict(pool_events=4, events_per_request=2,
                          draws_per_event=64, warmup_units=1, trace_units=1,
                          check_requests=2),
    "npe_r7.train": dict(batch=2, bank_segments=2, bank_segment_len=20000,
                         trace_units=1),
    "long_bns_v4.validate": dict(pool_triggers=32, triggers_per_request=16,
                                 draws_per_trigger=400, warmup_units=1,
                                 trace_units=1, check_requests=2),
}


def tiny_cell(name: str) -> registry.Cell:
    cell = registry.load_cell(name)
    return dataclasses.replace(cell, params={**cell.params, **TINY[name]})


def run_tiny(name: str, seed: int = 2**31 + 11, seconds: float = 1.0):
    """-> (result dict, checks) of one untraced run on the CPU."""
    torch.set_num_threads(2)
    return window.run_cell(tiny_cell(name), seed, seconds, False, "cpu",
                           time.perf_counter())
