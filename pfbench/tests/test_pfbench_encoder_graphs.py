"""The reader of the served encoder's graph share
(metrics/encoder_graph_share.sample.py): on hand-made snapshots, replays
over the calls of `pf.encoder`; None with nothing recorded and for a
program that counts none of the encoder's ways."""

from __future__ import annotations

import pytest

from pfbench.harness import program_spans, registry

NAME = "encoder_graph_share.sample"


def _span(calls, **counts):
    return {"calls": calls, "units": calls, "host_ms": 1.0,
            "self_host_ms": 1.0, "device_ms": 1.0, "counts": counts,
            "parents": {"pf.npe.encode": calls}}


def _read(snap, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return registry.reader(NAME).read(None)


def test_the_entry_reads_the_program_for_the_sampling_cell():
    (entry,) = [m for m in registry.load_benchmark()["per_layer"]
                if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "share", "better": "higher",
                     "source": "program_counter", "layer": "Encoder",
                     "moves": "draws_per_s", "workloads": ["npe_r7.sample"]}
    assert [m.name for m in registry.metrics_for("npe_r7.sample",
                                                 "per_layer")][-1] == NAME
    assert NAME not in {m.name for m in registry.metrics_for(
        "long_bns_v4.validate", "per_layer")}


@pytest.mark.parametrize("snap, want", [
    ({"pf.encoder": _span(4, encoder_graph_replay=4),
      "pf.flow.sample": _span(4)}, 1.0),
    ({"pf.encoder": _span(4, encoder_graph_replay=3,
                          encoder_graph_capture=1)}, 0.75),
    ({"pf.encoder": _span(8, encoder_eager=2, encoder_graph_replay=4,
                          encoder_graph_capture=1)}, 0.5),
    ({"pf.encoder": _span(4, encoder_eager=4)}, 0.0),
], ids=["replays", "one_capture", "training_calls_too", "eager"])
def test_replays_over_calls_of_the_encoder(snap, want, monkeypatch):
    assert _read(snap, monkeypatch) == pytest.approx(want)


@pytest.mark.parametrize("snap", [
    {},                                                  # no recorder
    {"pf.flow.sample": _span(4)},                        # no encoder span
    {"pf.encoder": _span(4, h2d_pageable=4)},            # no way counted
    {"pf.encoder": _span(0)},
], ids=["nothing", "no_encoder", "parent_program", "no_calls"])
def test_reads_none_without_the_counters(snap, monkeypatch):
    assert _read(snap, monkeypatch) is None
