"""A run with the timed path broken underneath reads `correct` false: each
fault that a cell can have (pfbench/faults.py), planted in the program at
a tiny size on the CPU, through the rest of the harness (set-up, window,
check). The exchange between cards is no fault of these one-card cells."""

from __future__ import annotations

import pytest

from pfbench.faults import FAULTS
from pfbench.tests.helpers import run_tiny

CASES = [("npe_r7.sample", "altered_answer"),
         ("long_bns_v4.validate", "altered_answer"),
         ("npe_r7.train", "state_unchanged"),
         ("npe_r7.train", "half_batch")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    with FAULTS[fault]():
        result, checks = run_tiny(name)
    assert result["correct"] is False
    assert any(not c.ok for c in checks)
    sound, _ = run_tiny(name)
    assert sound["correct"] is True
