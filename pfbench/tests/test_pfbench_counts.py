"""The yardstick's arithmetic: spline bytes against chip_smoke.py's
figures, and the FLOPs counted from shapes against what FlopCounterMode
sees the program dispatch (matrix products and convolutions) at a small
size on the CPU."""

from __future__ import annotations

import dataclasses
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from pfbench.counts import long_bns_v4, npe_r7
from pfbench.counts.rqs import rqs_bytes, rqs_grad_bytes
from pfbench.harness import registry, traffic

ROOT = registry.ROOT


def _cfg(name):
    return json.loads((ROOT / "pfbench" / "configs" / f"{name}.json")
                      .read_text())


def test_rqs_bytes_match_chip_smoke():
    # chip_smoke.py: 180 MB at [131072, 7], K = 16 (bound 53.8 µs);
    # 140.9 MB at [102400, 7]; 14.9 MB at long-BNS's [20000, 5], K = 12;
    # the backward 1.74 MB at [640, 7]
    assert round(rqs_bytes(131072, 7, 16) / 1e6) == 180
    assert round(rqs_bytes(131072, 7, 16) / 3.35e12 * 1e6, 1) == 53.8
    assert round(rqs_bytes(102400, 7, 16) / 1e6, 1) == 140.9
    assert round(rqs_bytes(20000, 5, 12) / 1e6, 1) == 14.9
    assert round(rqs_grad_bytes(640, 7, 16) / 1e6, 2) == 1.74


def _flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def _engine():
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.train.checkpoints import load_release
    sd, cfg, _ = load_release(ROOT / "model_release" / "npe_r7_best")
    eng = InferenceEngine(sd, cfg, device="cpu")
    # FlopCounterMode's module tracker asks a leaf that needs a gradient
    # for one under no_grad: serving needs none
    eng.model.requires_grad_(False)
    return eng


def test_npe_sample_flops_match_flop_counter():
    torch.manual_seed(0)
    cfg = _cfg("npe_r7")
    eng = _engine()
    b, n = 2, 4
    strain = torch.randn(b, 3, 16384)
    asd = torch.zeros(b, 3, 16)

    def request():
        ctx = eng.encode(strain, asd)
        eng.sample_posterior(ctx, 0, n, z=torch.randn(b, n, 15))
    assert _flops(request) == npe_r7.sample_request(cfg, b, n)["flops"]


def test_npe_train_flops_match_flop_counter():
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import (load_release,
                                                     train_cfg_from_dict)
    from posteriflow_torch.train.trainer import init_state, train_step
    cfg = _cfg("npe_r7")
    tcfg = dataclasses.replace(train_cfg_from_dict(cfg["config"]),
                               batch_size=2)
    state = init_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    state.model.load_state_dict(load_release(
        ROOT / "model_release" / "npe_r7_best")[0])
    batch = simulate_batch(2, tcfg.sim, device="cpu",
                           generator=traffic.generator("cpu", 1, 0))
    got = _flops(lambda: train_step(state, batch))
    assert got == npe_r7.train_step(cfg, 2)["flops"]


def test_long_bns_sample_flops_match_flop_counter():
    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.train.checkpoints import load_long_bns
    cfg = _cfg("long_bns_v4")
    model, _, grid = load_long_bns(ROOT / "model_release" / "long_bns_v4",
                                   device="cpu")
    b, n = 2, 4
    g = torch.Generator().manual_seed(0)
    h = torch.complex(torch.randn(b, 3, grid["cut"], generator=g),
                      torch.randn(b, 3, grid["cut"], generator=g))
    trig = torch.tensor([[1.2, 0.0, 0.01, 0.02]] * b)

    @torch.no_grad()
    def request():
        tok = lb.trigger_tokens(h, grid, trig[:, 0], trig[:, 1:])
        model.sample_raw(tok, trig, n, z=torch.randn(b, n, 11, generator=g))
    assert _flops(request) == long_bns_v4.sample_request(cfg, b, n)["flops"]
