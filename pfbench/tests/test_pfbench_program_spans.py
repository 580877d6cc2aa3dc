"""The readers of the program's own spans (harness/program_spans.py and
the metrics that use it): on a synthetic snapshot, the divisor of a
figure a unit is the calls of the path's entry span; with nothing
recorded a reader returns None. Then each driver's unit, profiled on the
CPU, gives the host readings of its cells (device times need the card)."""

from __future__ import annotations

import pytest

from pfbench.harness import program_spans, registry

NEW = {
    "encode_host_ms.sample", "geometry_ms.sample", "tokens_ms.sample",
    "conditioner_ms.sample", "rqs_host_us.sample", "h2d_copies.sample",
    "sim_waveform_ms.train", "sim_noise_ms.train", "backward_ms.train",
    "optimizer_ms.train", "rqs_host_us.train"}


def _span(calls, host_ms, device_ms=None, **counts):
    return {"calls": calls, "units": calls, "host_ms": host_ms,
            "self_host_ms": host_ms, "device_ms": device_ms,
            "counts": counts, "parents": {None: calls}}


# 4 traced requests of the flagship, 4 of long-BNS, 2 training steps
SAMPLE = {"pf.npe.encode": _span(4, 6.0, 5.0, h2d_pageable=8),
          "pf.encoder": _span(4, 40.0, 30.0),
          "pf.encoder.stem": _span(4, 8.0, 6.0, h2d_pageable=4),
          "pf.encoder.geometry": _span(4, 12.0, 10.0),
          "pf.npe.sample": _span(4, 90.0, 88.0),
          "pf.flow.sample": _span(4, 88.0, 86.0),
          "pf.flow.conditioner": _span(40, 70.0, 72.0),
          "pf.rqs": _span(40, 2.0, 3.2)}
LONG_BNS = {"pf.lbns.tokens": _span(4, 8.0, 6.0),
            "pf.lbns.sample": _span(4, 30.0, 28.0),
            "pf.lbns.encoder": _span(4, 12.0, 10.0),
            "pf.flow.sample": _span(4, 16.0, 16.0),
            "pf.flow.conditioner": _span(24, 10.0, 12.0),
            "pf.rqs": _span(24, 1.2, 1.0)}
TRAIN = {"pf.sim.batch": _span(2, 130.0, 134.0),
         "pf.sim.waveform": _span(2, 50.0, 60.0),
         "pf.sim.crops": _span(2, 4.0, 6.0),
         "pf.sim.assemble": _span(2, 20.0, 30.0),
         "pf.train.step": _span(2, 270.0, 272.0),
         "pf.train.backward": _span(2, 100.0, 150.0),
         "pf.train.grad_norms": _span(2, 4.0, 5.0),
         "pf.train.adamw": _span(2, 10.0, 13.0),
         "pf.rqs": _span(20, 0.6, 0.3),
         "pf.rqs.grad": _span(20, 0.8, 0.1)}
WANT = {
    "npe_r7.sample": {"encode_host_ms.sample": 10.0,
                      "geometry_ms.sample": 2.5,
                      "conditioner_ms.sample": 18.0,
                      "rqs_host_us.sample": 50.0,
                      "h2d_copies.sample": 3.0},
    "long_bns_v4.validate": {"encode_host_ms.sample": 5.0,
                             "tokens_ms.sample": 1.5,
                             "conditioner_ms.sample": 3.0,
                             "rqs_host_us.sample": 50.0,
                             "h2d_copies.sample": 0.0},
    "npe_r7.train": {"sim_waveform_ms.train": 30.0,
                     "sim_noise_ms.train": 18.0,
                     "backward_ms.train": 75.0,
                     "optimizer_ms.train": 9.0,
                     "rqs_host_us.train": 35.0},
}
SNAPS = {"npe_r7.sample": SAMPLE, "long_bns_v4.validate": LONG_BNS,
         "npe_r7.train": TRAIN}


def _read(metric):
    return registry.reader(metric).read(None)


def test_every_new_metric_is_a_program_span_of_its_cells():
    entries = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}
    assert NEW <= set(entries)
    for name in NEW:
        assert entries[name]["source"] == "program_span"
        cells = [c for c, want in WANT.items() if name in want]
        assert entries[name]["workloads"] == cells


@pytest.mark.parametrize("cell", sorted(WANT))
def test_readers_on_a_synthetic_snapshot(cell, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: SNAPS[cell])
    got = {m.name: _read(m.name)
           for m in registry.metrics_for(cell, "per_layer")
           if m.name in NEW}
    assert got == pytest.approx(WANT[cell])


@pytest.mark.parametrize("metric", sorted(NEW))
def test_a_reader_returns_none_with_nothing_recorded(metric, monkeypatch):
    monkeypatch.setattr(program_spans, "snapshot", lambda: {})
    assert _read(metric) is None


def test_a_unit_without_its_entry_span_reads_none(monkeypatch):
    """Spans recorded outside the path's entry (no pf.flow.sample) give no
    figure a request."""
    snap = {k: v for k, v in SAMPLE.items() if k != "pf.flow.sample"}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert _read("conditioner_ms.sample") is None
    assert _read("h2d_copies.sample") is None
    assert _read("rqs_host_us.sample") == pytest.approx(50.0)


@pytest.mark.parametrize("cell", sorted(WANT))
def test_a_profiled_unit_gives_the_host_readings(cell):
    """One unit of the cell's driver at a tiny size, profiled on the CPU:
    the host readings are there, the device times are not (no CUDA
    events off the card), and no copy to a card is counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pfbench.harness.spans import Spans
    from pfbench.tests.helpers import tiny_cell
    from posteriflow_torch.utils import logging as plog
    torch.set_num_threads(2)
    c = tiny_cell(cell)
    dev = torch.device("cpu")
    drv = registry.driver_module(c.driver).Driver(c, 2**31 + 7, dev,
                                                  Spans(dev, False))
    first = drv.setup()
    plog.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            drv.run_unit(first)
        got = {m: _read(m) for m in WANT[cell]}
    finally:
        plog.reset()
        drv.release()
    host = {m for m in got if "host" in m or "copies" in m}
    assert all(got[m] is not None and got[m] >= 0 for m in host)
    assert all(got[m] is None for m in set(got) - host)
    assert got.get("h2d_copies.sample", 0.0) == 0.0
