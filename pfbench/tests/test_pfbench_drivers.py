"""Each driver through a 1-second window on the CPU at a tiny size (the
model at its published widths, the plain spline), the result line's keys,
and no module of the JAX stack loaded by a run."""

from __future__ import annotations

import json

import pytest

from pfbench.harness import registry, window
from pfbench.tests.helpers import run_tiny

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_driver_runs_a_one_second_window(name):
    result, checks = run_tiny(name)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m.name for m in registry.metrics_for(name, "end_to_end")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert checks and all(c.ok for c in checks)
    assert {c.name for c in checks} == set(line["checks"])
    assert window.forbidden_modules() == []


def test_training_rechecks_the_window_state():
    """After the window the same state, put back to the release and the
    optimizer's first state, takes the checked steps again and reads as
    set-up's did (the CPU rounds alike both times)."""
    import torch

    from pfbench.harness.spans import Spans
    from pfbench.tests.helpers import tiny_cell
    torch.set_num_threads(2)
    cell = tiny_cell("npe_r7.train")
    dev = torch.device("cpu")
    drv = registry.driver_module(cell.driver).Driver(cell, 2**31 + 5, dev,
                                                     Spans(dev, False))
    first = drv.setup()
    state = drv.state
    for i in range(first, first + 2):
        drv.run_unit(i)
    drv.after_window()
    assert drv.state is state and len(drv.passes) == 2
    assert drv.passes[0] == drv.passes[1]
    drv.release()
    got = drv.readings()
    assert all(c.ok for c in drv.check()), got
