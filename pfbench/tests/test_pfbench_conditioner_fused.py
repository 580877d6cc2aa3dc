"""The reader of the flow conditioner's fused share
(metrics/conditioner_fused_share.sample.py): on hand-made snapshots,
`conditioner_fused` over the calls of `pf.flow.conditioner`; None with
nothing recorded and for a program that counts neither way."""

from __future__ import annotations

import pytest

from pfbench.harness import program_spans, registry

NAME = "conditioner_fused_share.sample"


def _span(calls, **counts):
    return {"calls": calls, "units": 4, "host_ms": 1.0,
            "self_host_ms": 1.0, "device_ms": 1.0, "counts": counts,
            "parents": {"pf.flow.sample": calls}}


def _read(snap, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return registry.reader(NAME).read(None)


def test_the_entry_reads_the_program_for_the_served_cells():
    (entry,) = [m for m in registry.load_benchmark()["per_layer"]
                if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "share", "better": "higher",
                     "source": "program_counter", "layer": "Flow",
                     "moves": "draws_per_s",
                     "workloads": ["npe_r7.sample", "long_bns_v4.validate"]}
    for cell in entry["workloads"]:
        assert NAME in {m.name for m in registry.metrics_for(
            cell, "per_layer")}
    for cell in ("npe_r7.train", "dingo_nsf30.sample"):
        assert NAME not in {m.name for m in registry.metrics_for(
            cell, "per_layer")}


@pytest.mark.parametrize("snap, want", [
    ({"pf.flow.conditioner": _span(40, conditioner_fused=40),
      "pf.flow.sample": _span(4)}, 1.0),
    ({"pf.flow.conditioner": _span(24, conditioner_fused=24)}, 1.0),
    ({"pf.flow.conditioner": _span(40, conditioner_fused=30,
                                   conditioner_eager=10)}, 0.75),
    ({"pf.flow.conditioner": _span(40, conditioner_eager=40)}, 0.0),
], ids=["sample", "long_bns", "mixed", "eager"])
def test_fused_over_calls_of_the_conditioner(snap, want, monkeypatch):
    assert _read(snap, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    {},                                                  # no recorder
    {"pf.flow.sample": _span(4)},                        # no conditioner
    {"pf.flow.conditioner": _span(40)},                  # parent program
    {"pf.flow.conditioner": _span(0)},
], ids=["nothing", "no_conditioner", "parent_program", "no_calls"])
def test_reads_none_without_the_counters(snap, monkeypatch):
    assert _read(snap, monkeypatch) is None
