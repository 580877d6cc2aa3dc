"""The DINGO cell's yardstick and check: counts/dingo_nsf30.py against
figures worked out by hand at the tiny size, and against what
FlopCounterMode sees the program dispatch; the event pool; the driver's
check on the CPU at the tiny size (conftest.py), sound and with the
served draws altered."""

from __future__ import annotations

import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from pfbench.counts import dingo_nsf30
from pfbench.counts.rqs import rqs_bytes
from pfbench.faults import FAULTS
from pfbench.harness import registry
from pfbench.tests.conftest import DINGO_TINY
from pfbench.tests.helpers import run_tiny, tiny_cell

CELL = "dingo_nsf30.sample"


def _tiny_config() -> dict:
    return {"config": json.loads((registry.ROOT / DINGO_TINY / "meta.json")
                                 .read_text())["config"]}


def test_counts_by_hand_at_the_tiny_size():
    """n_f 64, 3 detectors, n_rb 4, widths [16, 16, 8, 8], context 8;
    30 steps of hidden 16, 2 blocks, K = 8, 15 parameters."""
    cfg = _tiny_config()
    # projection 3 · 2·8·192, first Linear 2·16·24, blocks 2·2·16·16 twice
    # and 2·2·8·8 twice, resize 2·8·16, last Linear 2·8·8
    assert dingo_nsf30.embedding_flops(cfg, 1) == (
        9216 + 768 + 2048 + 512 + 256 + 128)
    # a step over R rows: the first layer's x columns 2·R·16·n_id and its
    # context columns 2·16·8, 2 blocks of 2·(2·R·16·16) and a gate 2·16·8,
    # the last layer 2·R·16·(23·n_tr); even steps n_tr 8, odd 7
    r = 64
    even = 2 * r * 16 * 7 + 256 + 2 * (2 * 2 * r * 16 * 16 + 256) \
        + 2 * r * 16 * 23 * 8
    odd = 2 * r * 16 * 8 + 256 + 2 * (2 * 2 * r * 16 * 16 + 256) \
        + 2 * r * 16 * 23 * 7
    assert (even, odd) == (8160 * r + 768, 7456 * r + 768)
    assert dingo_nsf30.flow_flops(cfg, r, 1) == 15 * (even + odd)
    got = dingo_nsf30.sample_request(cfg, 1, r)
    assert got["flops"] == 12928 + 15 * (even + odd) == 15_027_328
    # the spline, no bias: 4·(R·d + R·d·23 + R·d + R) bytes a step
    assert rqs_bytes(r, 8, 8, bias=False) == 4 * (512 + 11776 + 512 + 64)
    assert got["rqs_tile_bytes"] == 15 * (51456 + 45056) == 1_447_680


def test_counts_of_the_cell():
    """A request of the cell: 162.8 MFLOP a draw, 1.131 GB of spline."""
    cell = registry.load_cell(CELL)
    got = dingo_nsf30.sample_request(cell.config, 1, 50000)
    assert got == {"flops": 8_140_929_861_664,
                   "rqs_tile_bytes": 1_131_000_000}


def test_counts_match_the_flop_counter():
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.train.checkpoints import load_dingo
    torch.set_num_threads(2)
    sd, cfg, _ = load_dingo(registry.ROOT / DINGO_TINY, 5)
    eng = InferenceEngine(sd, cfg, device="cpu")
    eng.model.requires_grad_(False)
    strain = torch.randn(2, 3, 3, cfg.n_freq)
    counter = FlopCounterMode(display=False)
    with counter:
        ctx = eng.encode(strain, None)
        eng.sample_posterior(ctx, 0, 32)
    want = dingo_nsf30.embedding_flops(_tiny_config(), 2) \
        + dingo_nsf30.flow_flops(_tiny_config(), 64, 2)
    assert counter.get_total_flops() == want


def test_the_pool_is_seeded_pageable_strain():
    from pfbench.drivers.dingo_sample import event_pool
    d = _tiny_config()["config"]["dingo"]
    a = event_pool(d, 3, 2**31 + 5, torch.device("cpu"))
    b = event_pool(d, 3, 2**31 + 5, torch.device("cpu"))
    c = event_pool(d, 3, 2**31 + 6, torch.device("cpu"))
    assert a.shape == (3, 3, 3, 64) and a.dtype == torch.float32
    assert not a.is_pinned() and torch.equal(a, b) and not torch.equal(a, c)
    # real and imaginary parts: the signal over unit normal noise; the
    # third channel 1 / (ASD·10²³), the same for every event
    assert 0.5 < float(a[:, :, :2].std()) < 5.0
    assert torch.equal(a[0, :, 2], a[2, :, 2]) and bool((a[:, :, 2] > 0)
                                                         .all())


def test_the_check_passes_sound_and_fails_altered():
    sound, checks = run_tiny(CELL)
    assert sound["correct"] is True and all(c.ok for c in checks)
    assert set(sound["checks"]) == set(tiny_cell(CELL).params["limits"])
    with FAULTS["altered_answer"]():
        result, checks = run_tiny(CELL)
    assert result["correct"] is False
    assert any(not c.ok for c in checks)
