"""The span recorder of utils/logging.py and the spans of the port's paths.

Spans are live only while a torch profiler records; these tests record on
the CPU under torch.profiler.profile(activities=[CPU]) and check what is
recorded (names, nesting, units, counts), never a time. The tests marked
`cuda` need a card and skip without one.

This file imports neither JAX nor the JAX package, so that it runs on the
card too (python -m pytest --noconftest tests/test_torch_spans.py).
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.data.noise_bank import make_synthetic_bank
from posteriflow_torch.inference.pipeline import InferenceEngine
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.models.npe import LeanNPE, NPEConfig
from posteriflow_torch.physics.simulator import SimConfig, simulate_batch
from posteriflow_torch.prior import PriorConfig
from posteriflow_torch.train.trainer import (TrainConfig, init_state,
                                             train_step)
from posteriflow_torch.utils import logging as plog

NPE = NPEConfig(param_names=PARAM_NAMES_PRECESSING, context_dim=32,
                rank_dim=8, flow_layers=2, flow_hidden=32, flow_bins=4,
                encoder_type="coherent", d_model=32, enc_layers=1,
                enc_heads=4, flow_dtype="float32")
SIM = SimConfig(prior=PriorConfig(max_signals=2, precessing=True),
                real_noise_prob=0.5)
ENCODER_PARTS = ("pf.encoder.energy", "pf.encoder.geometry",
                 "pf.encoder.stem", "pf.encoder.fusion", "pf.encoder.head")


@pytest.fixture(autouse=True)
def fresh_recorder():
    plog.reset()
    yield
    plog.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans_of(snap, names):
    return {n: (snap[n]["calls"], snap[n]["units"], snap[n]["parents"])
            for n in names}


def test_no_profiler_records_nothing():
    s = plog.span("pf.off")
    assert s is plog.span("pf.other")                   # one shared object
    with s:
        plog.count("k", 3)
        plog.count_h2d(np.zeros(4, np.float32), "cuda")
    assert plog.snapshot() == {}


def test_nesting_parents_units_self_time_and_counts():
    with _cpu_profile():
        for _ in range(2):
            with plog.span("pf.unit"):
                with plog.span("pf.a"):
                    plog.count("k", 2)
                    with plog.span("pf.a.leaf"):
                        plog.count("k", 5)
                with plog.span("pf.a"):
                    plog.count("k")
                plog.count("top", 1.5)
        with plog.span("pf.b"):
            pass
    snap = plog.snapshot()
    assert set(snap) == {"pf.unit", "pf.a", "pf.a.leaf", "pf.b"}
    assert _spans_of(snap, snap) == {
        "pf.unit": (2, 2, {None: 2}), "pf.a": (4, 2, {"pf.unit": 4}),
        "pf.a.leaf": (2, 2, {"pf.a": 2}), "pf.b": (1, 1, {None: 1})}
    # a count goes to the innermost live span alone
    assert snap["pf.a"]["counts"] == {"k": 6}
    assert snap["pf.a.leaf"]["counts"] == {"k": 10}
    assert snap["pf.unit"]["counts"] == {"top": 3.0}
    # self time: a span's host time less its children's
    u, a, leaf = snap["pf.unit"], snap["pf.a"], snap["pf.a.leaf"]
    assert u["self_host_ms"] == pytest.approx(
        u["host_ms"] - a["host_ms"], abs=1e-9)
    assert a["self_host_ms"] == pytest.approx(
        a["host_ms"] - leaf["host_ms"], abs=1e-9)
    assert leaf["self_host_ms"] == pytest.approx(leaf["host_ms"], abs=1e-9)
    assert all(v["device_ms"] is None for v in snap.values())  # no CUDA
    plog.reset()
    assert plog.snapshot() == {}


def test_pending_records_fold_into_the_same_totals():
    rec = plog.SpanRecorder()
    units = plog.PENDING_MAX // 2 + 1           # PENDING_MAX + 2 records
    with _cpu_profile():
        for _ in range(units):
            with rec.span("pf.u"):
                with rec.span("pf.c"):
                    rec.count("n", 2)
        assert len(rec._pending) < plog.PENDING_MAX
        assert rec._totals                      # folded before snapshot()
    snap = rec.snapshot()
    assert _spans_of(snap, snap) == {"pf.u": (units, units, {None: units}),
                                     "pf.c": (units, units,
                                              {"pf.u": units})}
    assert snap["pf.c"]["counts"] == {"n": 2 * units}


def test_an_exception_inside_a_span_closes_it():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with plog.span("pf.outer"):
                with plog.span("pf.fails"):
                    raise ValueError("inside")
        with plog.span("pf.after"):
            pass
    snap = plog.snapshot()
    assert _spans_of(snap, snap) == {"pf.outer": (1, 1, {None: 1}),
                                     "pf.fails": (1, 1, {"pf.outer": 1}),
                                     "pf.after": (1, 1, {None: 1})}
    assert plog.RECORDER._stack() == []


def test_spans_on_another_thread_keep_their_own_stack():
    """A span opened on another thread (autograd's, in a backward on the
    card) has no parent from this thread's stack, and belongs to the unit
    that is live here."""
    def work():
        with plog.span("pf.thread"):
            with plog.span("pf.thread.child"):
                pass

    with _cpu_profile():
        with plog.span("pf.unit"):
            with plog.span("pf.inner"):
                for _ in range(2):
                    t = threading.Thread(target=work)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
            with plog.span("pf.inner2"):
                pass
    snap = plog.snapshot()
    assert _spans_of(snap, snap) == {
        "pf.unit": (1, 1, {None: 1}), "pf.inner": (1, 1, {"pf.unit": 1}),
        "pf.inner2": (1, 1, {"pf.unit": 1}),
        "pf.thread": (2, 1, {None: 2}),
        "pf.thread.child": (2, 1, {"pf.thread": 2})}
    # the threads' spans are not children of pf.inner here
    inner = snap["pf.inner"]
    assert inner["self_host_ms"] == pytest.approx(inner["host_ms"],
                                                  abs=1e-9)


def test_chrome_trace_holds_the_ranges_nested_as_recorded(tmp_path):
    with _cpu_profile() as prof:
        with plog.span("pf.unit"):
            with plog.span("pf.a"):
                with plog.span("pf.a.leaf"):
                    torch.ones(3).sum()
            with plog.span("pf.b"):
                torch.ones(3).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e["name"].startswith("pf.")]
    assert all(e["cat"] == "user_annotation" for e in events)
    by_name = {e["name"]: e for e in events}
    snap = plog.snapshot()
    assert sorted(by_name) == sorted(snap)
    assert len(events) == len(snap)

    def inside(child, parent):
        return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
                <= parent["ts"] + parent["dur"])

    for name, v in snap.items():
        (parent,) = v["parents"]
        if parent is not None:
            assert inside(by_name[name], by_name[parent])
    assert not inside(by_name["pf.b"], by_name["pf.a"])


def test_user_scope_session_holds_the_ranges_and_no_operator(tmp_path):
    """torch_trace's session on a card, here with the CPU's activity
    alone: the pf.* ranges are recorded, no host operator is."""
    with plog.UserScopeProfile([ProfilerActivity.CPU]) as prof:
        with plog.span("pf.unit"):
            with plog.span("pf.a"):
                torch.ones(3).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") != "Trace"]
    assert sorted(names) == ["pf.a", "pf.unit"]
    assert _spans_of(plog.snapshot(), ["pf.a"]) == {
        "pf.a": (1, 1, {"pf.unit": 1})}


# ── the program's paths ───────────────────────────────────────────────────


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(3)
    return InferenceEngine(LeanNPE(NPE).state_dict(), NPE, device="cpu")


def _request(engine, seed):
    rng = np.random.default_rng(seed)
    strain = rng.standard_normal((2, 3, 16384)).astype(np.float32)
    asd = (0.1 * rng.standard_normal((2, 3, 16))).astype(np.float32)
    z = torch.from_numpy(rng.standard_normal((2, 16, 15))
                         .astype(np.float32)).to(engine.device)
    ctx = engine.encode(strain, asd)
    return (ctx,) + engine.sample_posterior(ctx, 0, 16, z=z)


def test_served_path_spans_and_outputs(engine):
    off = [_request(engine, s) for s in (1, 2)]
    with _cpu_profile():
        live = [_request(engine, s) for s in (1, 2)]
    for a, b in zip(off, live):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    snap = plog.snapshot()
    layers = NPE.flow_layers
    want = {"pf.npe.encode": (2, 2, {None: 2}),
            "pf.encoder": (2, 2, {"pf.npe.encode": 2}),
            "pf.npe.sample": (2, 2, {None: 2}),
            "pf.flow.sample": (2, 2, {"pf.npe.sample": 2}),
            "pf.flow.conditioner": (2 * layers, 2, {"pf.flow.sample":
                                                    2 * layers}),
            "pf.rqs": (2 * layers, 2, {"pf.flow.sample": 2 * layers})}
    want.update({n: (2, 2, {"pf.encoder": 2}) for n in ENCODER_PARTS})
    assert _spans_of(snap, snap) == want
    # the host arrays stay on the CPU here: nothing is copied to a card;
    # each conditioner call counts its way, the eager ops off the card
    assert snap["pf.flow.conditioner"]["counts"] == {
        "conditioner_eager": 2 * layers}
    assert all(v["counts"] == {} for k, v in snap.items()
               if k != "pf.flow.conditioner")


def test_simulator_spans_with_a_bank():
    gen = torch.Generator().manual_seed(5)
    bank = make_synthetic_bank(gen, n_segments=2, segment_len=20000,
                               device="cpu")

    def batch():
        return simulate_batch(
            2, SIM, device="cpu",
            generator=torch.Generator().manual_seed(9), bank=bank)

    off = batch()
    with _cpu_profile():
        live = batch()
    for x, y in zip(off, live):
        assert torch.equal(x, y)
    snap = plog.snapshot()
    child = (1, 1, {"pf.sim.batch": 1})
    assert _spans_of(snap, snap) == {
        "pf.sim.batch": (1, 1, {None: 1}), "pf.sim.prior": child,
        "pf.sim.waveform": child, "pf.sim.crops": child,
        "pf.sim.assemble": child}


def test_train_step_spans_and_outputs():
    cfg = TrainConfig(npe=NPE, sim=SIM, batch_size=2, warmup_steps=1,
                      total_steps=4)
    batch = simulate_batch(2, SIM, device="cpu",
                           generator=torch.Generator().manual_seed(4))

    def two_steps():
        state = init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        nll = [train_step(state, batch)["nll"] for _ in range(2)]
        return nll, [p.detach().clone() for p in state.model.parameters()]

    off = two_steps()
    with _cpu_profile():
        live = two_steps()
    assert all(torch.equal(a, b) for a, b in zip(off[0], live[0]))
    assert all(torch.equal(a, b) for a, b in zip(off[1], live[1]))
    snap = plog.snapshot()
    layers = NPE.flow_layers
    in_step = (2, 2, {"pf.train.step": 2})
    want = {"pf.train.step": (2, 2, {None: 2}), "pf.train.nll": in_step,
            "pf.train.backward": in_step, "pf.train.grad_norms": in_step,
            "pf.train.adamw": in_step,
            "pf.encoder": (2, 2, {"pf.train.nll": 2}),
            "pf.flow.log_prob": (2, 2, {"pf.train.nll": 2}),
            "pf.flow.conditioner": (2 * layers, 2, {"pf.flow.log_prob":
                                                    2 * layers}),
            "pf.rqs": (2 * layers, 2, {"pf.flow.log_prob": 2 * layers})}
    want.update({n: (2, 2, {"pf.encoder": 2}) for n in ENCODER_PARTS})
    assert _spans_of(snap, snap) == want


@pytest.fixture(scope="module")
def long_bns():
    torch.manual_seed(7)
    model = tlb.LongBNSNPEv4(enc=dict(d_model=32, n_layers=1, n_heads=4,
                                      context_dim=16, patch=4),
                             flow_layers=2, flow_hidden=32, flow_bins=12)
    grid = tlb.build_trigger_token_grid(duration=16.0, f_hi=256.0,
                                        pad_multiple=32)
    return model.eval(), grid


def test_long_bns_v4_sample_spans_and_outputs(long_bns):
    model, grid = long_bns
    g = torch.Generator().manual_seed(11)
    n_bins = len(grid["freqs"])
    h = torch.complex(torch.randn(3, 3, n_bins, generator=g),
                      torch.randn(3, 3, n_bins, generator=g))
    mc = 1.2 + 0.01 * torch.rand(3, generator=g)
    t = 0.001 * torch.randn(3, 3, generator=g)
    trig = torch.cat([mc[:, None], t], dim=-1)
    z = torch.randn(3, 8, 11, generator=g)

    @torch.no_grad()
    def request():
        tok = tlb.trigger_tokens(h, grid, mc, t)
        return (tok,) + model.sample_raw(tok, trig, 8, z=z)

    off = request()
    with _cpu_profile():
        live = request()
    for x, y in zip(off, live):
        assert torch.equal(x, y)
    snap = plog.snapshot()
    assert _spans_of(snap, snap) == {
        "pf.lbns.tokens": (1, 1, {None: 1}),
        "pf.lbns.sample": (1, 1, {None: 1}),
        "pf.lbns.encoder": (1, 1, {"pf.lbns.sample": 1}),
        "pf.flow.sample": (1, 1, {"pf.lbns.sample": 1}),
        "pf.flow.conditioner": (2, 1, {"pf.flow.sample": 2}),
        "pf.rqs": (2, 1, {"pf.flow.sample": 2})}


# ── on the card ───────────────────────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_spans_time_copies_and_the_backward(cuda_device):
    """On the card: device times from the spans' events, the pageable
    copies of the served path counted (the strain and its bands a request;
    the encoder's positions were copied once, before), the served encoder's
    second call of a shape captured, and the spline's backward recorded on
    autograd's thread in the step's unit."""
    torch.manual_seed(3)
    eng = InferenceEngine(LeanNPE(NPE).state_dict(), NPE,
                          device=cuda_device)
    cfg = TrainConfig(npe=NPE, sim=SIM, batch_size=2, warmup_steps=1,
                      total_steps=4)
    state = init_state(cfg, torch.Generator().manual_seed(0), cuda_device)
    batch = simulate_batch(2, SIM, device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(4))
    _request(eng, 1)
    train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _request(eng, 2)
        train_step(state, batch)
    snap = plog.snapshot()
    strain_bytes = 2 * 3 * 16384 * 4
    bands_bytes = 2 * 3 * 16 * 4
    assert snap["pf.npe.encode"]["counts"] == {
        "h2d_pageable": 2, "h2d_pageable_bytes": strain_bytes + bands_bytes}
    assert snap["pf.encoder.stem"]["counts"] == {}
    assert snap["pf.encoder"]["counts"] == {"encoder_graph_capture": 1}
    assert all(v["device_ms"] is not None and v["device_ms"] >= 0
               for v in snap.values())
    grad = snap["pf.rqs.grad"]
    assert (grad["calls"], grad["units"]) == (NPE.flow_layers, 1)


@pytest.mark.cuda
def test_card_trace_keeps_the_spans(cuda_device, tmp_path):
    """torch_trace on the card: kernels, and the pf.* ranges on the host
    and on the card, without the host's operators."""
    torch.manual_seed(3)
    eng = InferenceEngine(LeanNPE(NPE).state_dict(), NPE,
                          device=cuda_device)
    _request(eng, 1)
    with plog.torch_trace(str(tmp_path), cuda_device):
        _request(eng, 2)
        torch.cuda.synchronize()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    cats = {e.get("cat") for e in events}
    pf = {e["name"] for e in events if e["name"].startswith("pf.")
          and e.get("cat") == "user_annotation"}
    assert "kernel" in cats and "cpu_op" not in cats
    assert pf == set(plog.snapshot())
