"""Tiny sizes of the cells whose configuration the CPU cannot run at its
published widths: helpers.tiny_cell cuts a cell's traffic, and here also
the model of `dingo_nsf30.sample` (~136 M parameters) to the one of
dingo_tiny/meta.json, the same blocks and steps at small widths."""

from __future__ import annotations

import dataclasses
import json

from pfbench.harness import registry
from pfbench.tests import helpers

DINGO_TINY = "pfbench/tests/dingo_tiny"

helpers.TINY.setdefault("dingo_nsf30.sample", dict(
    pool_events=2, draws_per_event=64, warmup_units=1, trace_units=1,
    check_requests=2))

_traffic_only = helpers.tiny_cell


def tiny_cell(name: str) -> registry.Cell:
    cell = _traffic_only(name)
    if cell.config["name"] == "dingo_nsf30":
        meta = json.loads((registry.ROOT / DINGO_TINY / "meta.json")
                          .read_text())
        cell = dataclasses.replace(cell, config={
            **cell.config, "release": DINGO_TINY, "config": meta["config"]})
    return cell


helpers.tiny_cell = tiny_cell
