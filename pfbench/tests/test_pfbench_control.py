"""The control of each cell: the plain reference one step of precision
below the configuration's (bf16 products to float8 e4m3, float32 to bf16),
in the program's place, fails the cell's limits.

On the CPU at a tiny size, and on the card at the cell's own size on three
seeds (marked `cuda`; on the card run
`python3 -m pytest -m cuda pfbench/tests -q`)."""

from __future__ import annotations

import pytest
import torch

from pfbench import control
from pfbench.harness import registry
from pfbench.tests.helpers import tiny_cell

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


def _fails(cell, readings) -> bool:
    return any(readings[k] > v for k, v in cell.params["limits"].items())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    got = control.readings(cell, 2**31 + 21, 2, torch.device("cpu"))
    assert not _fails(cell, got["program"]), got
    assert _fails(cell, got["control"]), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cell = registry.load_cell(name)
    for seed in (2**31 + 101, 2**32 + 7, 12345):
        got = control.readings(cell, seed, 4, torch.device("cuda:0"))
        assert not _fails(cell, got["program"]), got
        assert _fails(cell, got["control"]), got


@pytest.mark.parametrize("name", ["npe_r7.sample", "long_bns_v4.validate"])
def test_witness_reads_at_a_tiny_size(name):
    """The CPU witness of a served cell (the reference in the stated
    precision on the CPU against the reference on the run's device) runs;
    on the CPU both are one computation and read 0."""
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    got = control.readings(cell, 2**31 + 23, 2, torch.device("cpu"),
                           control=False, witness=True)
    assert got["witness"] == {k: 0.0 for k in got["witness"]}
    assert set(cell.params["limits"]) <= set(got["witness"])
