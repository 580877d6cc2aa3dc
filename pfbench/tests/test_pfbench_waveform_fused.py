"""The reader of the simulator's fused waveform share
(metrics/waveform_fused_share.train.py): on hand-made snapshots,
`waveform_fused` over the calls of `pf.sim.waveform`; None with nothing
recorded and for a program that counts neither way."""

from __future__ import annotations

import pytest

from pfbench.harness import program_spans, registry

NAME = "waveform_fused_share.train"


def _span(calls, **counts):
    return {"calls": calls, "units": 2, "host_ms": 1.0,
            "self_host_ms": 1.0, "device_ms": 1.0, "counts": counts,
            "parents": {"pf.sim.batch": calls}}


def _read(snap, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return registry.reader(NAME).read(None)


def test_the_entry_reads_the_program_for_the_training_cell():
    (entry,) = [m for m in registry.load_benchmark()["per_layer"]
                if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "share", "better": "higher",
                     "source": "program_counter", "layer": "Simulator",
                     "moves": "train_events_per_s",
                     "workloads": ["npe_r7.train"]}
    assert NAME in {m.name for m in registry.metrics_for("npe_r7.train",
                                                         "per_layer")}
    for cell in ("npe_r7.sample", "long_bns_v4.validate",
                 "dingo_nsf30.sample"):
        assert NAME not in {m.name for m in registry.metrics_for(
            cell, "per_layer")}


@pytest.mark.parametrize("snap, want", [
    ({"pf.sim.waveform": _span(2, waveform_fused=2),
      "pf.sim.batch": _span(2)}, 1.0),
    ({"pf.sim.waveform": _span(4, waveform_fused=3, waveform_eager=1)},
     0.75),
    ({"pf.sim.waveform": _span(2, waveform_eager=2)}, 0.0),
], ids=["fused", "mixed", "eager"])
def test_fused_over_calls_of_the_waveforms(snap, want, monkeypatch):
    assert _read(snap, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    {},                                                  # no recorder
    {"pf.sim.batch": _span(2)},                          # no waveforms
    {"pf.sim.waveform": _span(2)},                       # parent program
    {"pf.sim.waveform": _span(0)},
], ids=["nothing", "no_waveforms", "parent_program", "no_calls"])
def test_reads_none_without_the_counters(snap, monkeypatch):
    assert _read(snap, monkeypatch) is None
