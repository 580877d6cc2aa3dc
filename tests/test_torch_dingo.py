"""DINGO's posterior network in the port (models/dingo.py,
models/dingo_flow.py) against the benchmark's plain reference
(pfbench/reference/dingo.py, nflows' and dingo's modules written out in
plain torch), at a small size on the CPU with seeded weights; the LU
transform, the flow's round trip, the masks, the context gate, the
serving path through InferenceEngine and its spans.

Tolerances. Port and reference compute the same function in other orders
of float32 operations: the conditioner's first layer split into its x and
context columns, the logit scale folded into the last layer's rows, the
spline in the CUDA kernel's order against nflows'. Each rounds at ~1e-7
of a value; the flow's Jacobian, a product of 3 steps here, carries that
into the draws, so a draw's gap is held at 2e-5 of its parameter's σ and
log q at 2e-5 of its size (the same blocks with products one step lower,
in TF32, read ~1e-3 here). Exact identities (the round trip, the LU
determinant, the gate) are held to float32's own resolution.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pfbench.reference import dingo as ref
from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.inference.pipeline import InferenceEngine
from posteriflow_torch.models import dingo_flow
from posteriflow_torch.models.dingo import (DingoConfig, DingoNPE,
                                            dingo_config_from_dict,
                                            seeded_state_dict)
from posteriflow_torch.prior import PriorConfig, sample_signal_params
from posteriflow_torch.train.checkpoints import load_dingo
from posteriflow_torch.utils import logging as plog

ROOT = Path(__file__).resolve().parents[1]
META = json.loads((ROOT / "posteriflow_torch" / "models" / "configs"
                   / "dingo_nsf30" / "meta.json").read_text())
FULL = dingo_config_from_dict(META["config"])
SMALL = dataclasses.replace(FULL, f_max=20.0 + 0.125 * 63, n_rb=4,
                            resnet_widths=(32, 32, 16, 16), context_dim=16,
                            flow_steps=3, flow_hidden=32, flow_blocks=2)
SEED = 2**31 + 17


def _config_dict(cfg: DingoConfig) -> dict:
    return {"dingo": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in dataclasses.asdict(cfg).items()}}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    sd = seeded_state_dict(SMALL, SEED)
    eng = InferenceEngine(sd, SMALL, device="cpu")
    return eng, ref.build(_config_dict(SMALL), sd, "cpu")


def _strain(b: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 3, 3, SMALL.n_freq, generator=g)
    x[:, :, 2] = 0.5 + torch.rand(b, 3, SMALL.n_freq, generator=g)
    return x


def test_the_configuration_is_dingos_published_model():
    """The widths of dingo's example model block, 147.0 M parameters."""
    assert FULL.n_freq == 8033 and FULL.n_rb == 200
    assert FULL.resnet_widths == (1024,) * 8 + (512,) * 8 + (256,) * 8 \
        + (128,) * 8
    assert (FULL.context_dim, FULL.flow_steps, FULL.flow_hidden,
            FULL.flow_blocks, FULL.flow_bins, FULL.tail_bound,
            FULL.bn_eps) == (128, 30, 512, 5, 8, 1.0, 1e-3)
    assert FULL.param_names == PARAM_NAMES_PRECESSING
    with torch.device("meta"):
        m = DingoNPE(FULL)
    count = [sum(p.numel() for p in part.parameters())
             for part in (m.embedding.projection, m.embedding.resnet,
                          m.flow)]
    assert count == [28_920_000, 24_309_760, 93_770_055]
    bench = json.loads((ROOT / "pfbench" / "configs" / "dingo_nsf30.json")
                       .read_text())
    assert bench["config"] == META["config"] and bench["reduced"] == []


def test_standardisation_is_the_priors():
    """μ and σ are the port's precessing prior's, from 10⁶ seeded draws."""
    x = sample_signal_params((1_000_000,), PriorConfig(precessing=True),
                             generator=torch.Generator().manual_seed(0),
                             device="cpu").double()
    np.testing.assert_allclose(FULL.param_mean, x.mean(0).numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(FULL.param_std, x.std(0).numpy(), rtol=1e-9)


def test_port_draws_and_log_q_match_the_reference(models):
    eng, rm = models
    x = _strain(2, 1)
    z = torch.randn(2, 256, 15, generator=torch.Generator().manual_seed(2))
    ctx = eng.encode(x.numpy(), None)
    theta, log_q, railed = eng.sample_posterior(ctx, 0, 256, z=z)
    theta_r, log_q_r = ref.sample(rm, x, z, block=100)
    gaps = ref.draw_gaps(rm.std, theta, theta_r, log_q, log_q_r)
    assert gaps["draw_gap_p90"] < 2e-5 and gaps["logq_gap_p90"] < 2e-5, gaps
    assert gaps["draw_gap_max"] < 1e-3 and gaps["logq_gap_max"] < 1e-3, gaps
    assert not railed.any()
    assert torch.all(theta[..., 0] >= theta[..., 1])
    # the reference one step of precision lower is told apart
    theta_t, log_q_t = ref.sample(rm, x, z, block=100, allow_tf32=True)
    low = ref.draw_gaps(rm.std, theta_t, theta_r, log_q_t, log_q_r)
    assert low["draw_gap_p90"] > 1e-4 and low["logq_gap_p90"] > 1e-4, low


def test_port_log_density_matches_the_reference(models):
    eng, rm = models
    x = _strain(6, 3)
    theta = sample_signal_params((6,), PriorConfig(precessing=True),
                                 torch.Generator().manual_seed(4), "cpu")
    with torch.no_grad():
        ctx = eng.model.encode(x)
        nll = eng.model.nll_from_context(ctx, theta, torch.zeros(6))
    log_q_r = ref.log_prob(rm, x, theta)
    np.testing.assert_allclose(-nll.numpy(), log_q_r.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_sampling_then_density_gives_the_draws_log_q(models):
    """The flow's forward undoes its inverse: log q of a draw, evaluated
    again from the draw, is the sampler's log q."""
    eng, _ = models
    z = torch.randn(1, 128, 15, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        ctx = eng.model.encode(_strain(1, 6))
        theta, y, log_q = eng.model.sample_from_context(ctx, None, 128, z=z)
        z_back, _ = eng.model.flow(y, ctx[:, None, :])
        nll = eng.model.nll_from_context(ctx[:, None, :], theta, None)
    assert torch.max(torch.abs(z_back - z)) < 1e-5
    np.testing.assert_allclose(-nll.numpy(), log_q.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_lu_logabsdet_is_the_jacobians():
    torch.manual_seed(7)
    lin = dingo_flow.LULinear(15)
    with torch.no_grad():
        for p in (lin.lower_entries, lin.upper_entries, lin.bias):
            p.normal_(0.0, 0.3)
        lin.unconstrained_upper_diag.normal_(0.0, 1.0)
        lin.permutation.copy_(torch.randperm(15))
    x = torch.randn(15, dtype=torch.float64)
    lin = lin.double()
    jac = torch.autograd.functional.jacobian(lambda v: lin(v)[0], x)
    _, logdet = torch.linalg.slogdet(jac)
    y, ld = lin(x)
    assert float(ld.detach()) == pytest.approx(float(logdet), abs=1e-10)
    back, ld_inv = lin.inverse(y[None])
    assert torch.allclose(back[0], x, atol=1e-12)
    assert float(ld_inv.detach()) == pytest.approx(-float(logdet),
                                                   abs=1e-10)


def test_alternating_masks():
    tr, idn = dingo_flow.coupling_mask(15, 0)
    assert tr.tolist() == list(range(0, 15, 2)) and len(tr) == 8
    assert idn.tolist() == list(range(1, 15, 2))
    tr, idn = dingo_flow.coupling_mask(15, 1)
    assert tr.tolist() == list(range(1, 15, 2)) and len(tr) == 7
    step = DingoNPE(SMALL).flow.couplings[1]
    x = torch.randn(4, 15)
    with torch.no_grad():
        y, _ = step(x, torch.randn(4, SMALL.context_dim))
    assert torch.equal(y[:, 0::2], x[:, 0::2])       # identity features
    assert not torch.equal(y[:, 1::2], x[:, 1::2])


def test_context_gate_by_hand():
    """One context-gated block: h + t ⊙ σ(W_c c + b_c), t the block's
    branch, in the port and in the reference's nflows GLU."""
    torch.manual_seed(8)
    blk = dingo_flow.ResidualBlock(6, 3, eps=1e-3).eval()
    sd = {k: torch.randn_like(v) if v.is_floating_point() else v
          for k, v in blk.state_dict().items()}
    sd["bn.0.running_var"] = sd["bn.0.running_var"].abs() + 0.5
    sd["bn.1.running_var"] = sd["bn.1.running_var"].abs() + 0.5
    blk.load_state_dict(sd)
    h, c = torch.randn(5, 6), torch.randn(5, 3)
    p = {k: v.double().numpy() for k, v in sd.items()}

    def bn(i, v):
        return ((v - p[f"bn.{i}.running_mean"])
                / np.sqrt(p[f"bn.{i}.running_var"] + 1e-3)
                * p[f"bn.{i}.weight"] + p[f"bn.{i}.bias"])

    def elu(v):
        return np.where(v > 0, v, np.expm1(v))

    hd, cd = h.double().numpy(), c.double().numpy()
    t = elu(bn(0, hd)) @ p["linear.0.weight"].T + p["linear.0.bias"]
    t = elu(bn(1, t)) @ p["linear.1.weight"].T + p["linear.1.bias"]
    gate = 1.0 / (1.0 + np.exp(-(cd @ p["context.weight"].T
                                 + p["context.bias"])))
    want = hd + t * gate
    with torch.no_grad():
        got = blk(h, blk.gate(c))
        ref_blk = ref.ResidualBlock(6, 3, 1e-3).eval()
        ref_blk.load_state_dict(sd)
        got_ref = ref_blk(h, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_ref.numpy(), want, rtol=1e-5, atol=1e-5)


def test_engine_serves_a_request_from_a_seeded_directory(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps(
        {"model": "DingoNPE", "config": _config_dict(SMALL)}))
    sd, cfg, meta = load_dingo(tmp_path, SEED)
    assert cfg == SMALL and meta["model"] == "DingoNPE"
    again, _, _ = load_dingo(tmp_path, SEED)
    other, _, _ = load_dingo(tmp_path, SEED + 1)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["flow.linears.0.lower_entries"],
                           other["flow.linears.0.lower_entries"])
    eng = InferenceEngine(sd, cfg, device="cpu")
    assert eng.served_encoder is None
    ctx = eng.encode(_strain(1, 9).numpy(), None)
    theta, log_q, railed = eng.sample_posterior(
        ctx, 0, 32, generator=torch.Generator().manual_seed(1))
    assert theta.shape == (1, 32, 15) and log_q.shape == (1, 32)
    assert torch.isfinite(theta).all() and torch.isfinite(log_q).all()
    with pytest.raises(ValueError, match="rank 1"):
        eng.sample_posterior(ctx, 1, 32)
    with pytest.raises(ValueError, match="strain must be"):
        eng.encode(np.zeros((1, 3, 16384), np.float32), None)


def test_every_seeded_part_moves_the_draws(models):
    """Each kind of weight, scaled by 1.05, moves the draws well past the
    port's gap to the reference: no part is idle at the seeded scales."""
    eng, _ = models
    sd = seeded_state_dict(SMALL, SEED)
    x = _strain(1, 10)
    z = torch.randn(1, 256, 15, generator=torch.Generator().manual_seed(11))

    def draws(state):
        e = InferenceEngine(state, SMALL, device="cpu")
        return e.sample_posterior(e.encode(x, None), 0, 256, z=z)[0]

    base = draws(sd)
    parts = ("embedding.projection.layers.0.weight",
             "embedding.resnet.blocks.1.linear.1.weight",
             "embedding.resnet.blocks.2.bn.0.running_var",
             "flow.linears.1.lower_entries", "flow.linears.3.bias",
             "flow.couplings.0.net.initial.weight",
             "flow.couplings.1.net.blocks.1.linear.1.weight",
             "flow.couplings.2.net.blocks.0.context.weight",
             "flow.couplings.2.net.blocks.1.bn.1.running_mean")
    std = torch.tensor(SMALL.param_std)
    for name in parts:
        moved = {**sd, name: sd[name] * 1.05}
        gap = torch.median(torch.amax(torch.abs(draws(moved) - base) / std,
                                      dim=-1))
        assert gap > 1e-4, name
    # the width and height rows and the derivative rows of a spline's
    # parameters each matter
    w = sd["flow.couplings.1.net.final.weight"].view(7, 23, -1)
    for rows in (slice(0, 8), slice(8, 16), slice(16, 23)):
        moved_w = w.clone()
        moved_w[:, rows] *= 1.05
        gap = torch.median(torch.amax(torch.abs(draws(
            {**sd, "flow.couplings.1.net.final.weight":
             moved_w.view_as(sd["flow.couplings.1.net.final.weight"])})
            - base) / std, dim=-1))
        assert gap > 1e-5, rows


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_of_a_served_request(models):
    eng, _ = models
    plog.reset()
    x = _strain(1, 12).numpy()
    try:
        with _cpu_profile():
            ctx = eng.encode(x, None)
            eng.sample_posterior(ctx, 0, 16)
        snap = plog.snapshot()
    finally:
        plog.reset()
    steps = SMALL.flow_steps
    got = {n: (v["calls"], v["parents"]) for n, v in snap.items()}
    assert got == {
        "pf.npe.encode": (1, {None: 1}),
        "pf.dingo.embed": (1, {"pf.npe.encode": 1}),
        "pf.dingo.embed.projection": (1, {"pf.dingo.embed": 1}),
        "pf.dingo.embed.resnet": (1, {"pf.dingo.embed": 1}),
        "pf.npe.sample": (1, {None: 1}),
        "pf.flow.sample": (1, {"pf.npe.sample": 1}),
        "pf.flow.linear": (steps + 1, {"pf.flow.sample": steps + 1}),
        "pf.flow.conditioner": (steps, {"pf.flow.sample": steps}),
        "pf.rqs": (steps, {"pf.flow.sample": steps})}
