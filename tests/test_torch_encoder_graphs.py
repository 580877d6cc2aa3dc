"""The served encoder's CUDA graphs (inference/encoder_graphs.py).

On the CPU: the engagement policy, a CPU engine's path, the parts of the
forward, the device table of positions and the recorder's pause. The
tests marked `cuda` hold, at the flagship's shapes (npe_r7_best,
T = 16,384, bands on), the replayed context bit-equal to the eager one,
training's calls with gradients outside the graphs, and the spans of
a replay; they skip without a card.

This file imports neither JAX nor the JAX package, so that it runs on the
card too (python -m pytest --noconftest tests/test_torch_encoder_graphs.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import encoder_graphs as eg
from posteriflow_torch.inference.pipeline import InferenceEngine
from posteriflow_torch.models.encoder import (CoherentEncoder,
                                              LeanStrainEncoder,
                                              sinusoidal_positions)
from posteriflow_torch.models.npe import LeanNPE, NPEConfig
from posteriflow_torch.train.checkpoints import load_release
from posteriflow_torch.utils import logging as plog

NPE = NPEConfig(param_names=PARAM_NAMES_PRECESSING, context_dim=32,
                rank_dim=8, flow_layers=2, flow_hidden=32, flow_bins=4,
                encoder_type="coherent", d_model=32, enc_layers=1,
                enc_heads=4, flow_dtype="float32")
ENCODER_PARTS = ("pf.encoder.energy", "pf.encoder.geometry",
                 "pf.encoder.stem", "pf.encoder.fusion", "pf.encoder.head")
RELEASE = Path(__file__).resolve().parents[1] / "model_release/npe_r7_best"
T = 16384


@pytest.fixture(autouse=True)
def fresh_recorder():
    plog.reset()
    yield
    plog.reset()


def _inputs(b, seed, k=16):
    rng = np.random.default_rng(seed)
    strain = rng.standard_normal((b, 3, T)).astype(np.float32)
    bands = (0.1 * rng.standard_normal((b, 3, k))).astype(np.float32)
    return strain, bands


# ── the policy ────────────────────────────────────────────────────────────


def test_a_key_goes_eager_then_capture_then_replay():
    pol = eg.GraphPolicy()
    key = ((8, 3, T), (8, 3, 16))
    assert pol.step(key) == eg.EAGER
    assert pol.step(key) == eg.CAPTURE          # nothing stored yet
    pol.store(key, "graphs")
    assert [pol.step(key) for _ in range(3)] == [eg.REPLAY] * 3
    assert pol.get(key) == "graphs"
    # a new key starts eager, and leaves the first one as it was
    other = ((1, 3, T), (1, 3, 16))
    assert pol.step(other) == eg.EAGER
    assert pol.step(key) == eg.REPLAY


def test_a_capture_that_stored_nothing_is_tried_again():
    pol = eg.GraphPolicy()
    pol.step("k")
    assert pol.step("k") == eg.CAPTURE
    assert pol.step("k") == eg.CAPTURE


def test_the_ninth_key_drops_the_least_recently_used():
    assert eg.MAX_KEYS == 8
    pol = eg.GraphPolicy()
    for b in range(8):
        assert pol.step(b) == eg.EAGER
        pol.store(b, f"g{b}")
    assert pol.step(0) == eg.REPLAY             # 0 is now the most recent
    assert pol.step(8) == eg.EAGER              # evicts 1, not 0
    assert pol.get(1) is None
    assert [pol.get(b) for b in (0, 2, 3, 4, 5, 6, 7)] == [
        f"g{b}" for b in (0, 2, 3, 4, 5, 6, 7)]
    assert pol.step(1) == eg.EAGER              # back from the start
    assert pol.get(2) is None and pol.get(3) == "g3"   # 2 went next
    assert pol.step(0) == eg.REPLAY


def test_shape_key_of_arrays_and_tensors():
    s, b = _inputs(2, 0)
    assert eg.shape_key(s, b) == ((2, 3, T), (2, 3, 16))
    assert eg.shape_key(torch.from_numpy(s), None) == ((2, 3, T), None)


@pytest.mark.parametrize("into", [False, True])
@pytest.mark.parametrize("with_bands", [False, True])
def test_to_device_makes_or_fills_float32_tensors(into, with_bands):
    strain, bands = _inputs(2, 6)
    bands = bands if with_bands else None
    bufs = ((torch.empty(strain.shape),
             torch.empty(bands.shape) if with_bands else None)
            if into else (None, None))
    s, b = eg.to_device(strain.astype(np.float64), bands, "cpu", into=bufs)
    assert s.dtype == torch.float32 and np.array_equal(s.numpy(), strain)
    assert (b is None) is (not with_bands)
    if with_bands:
        assert np.array_equal(b.numpy(), bands)
    if into:
        assert s is bufs[0] and b is bufs[1]


# ── the paths that bypass the graphs ──────────────────────────────────────


@pytest.fixture(scope="module")
def cpu_engine():
    torch.manual_seed(3)
    return InferenceEngine(LeanNPE(NPE).state_dict(), NPE, device="cpu")


def test_a_cpu_engine_never_takes_the_graph_path(cpu_engine):
    strain, bands = _inputs(2, 1)
    with torch.no_grad():
        want = cpu_engine.model.encode(torch.from_numpy(strain),
                                       torch.from_numpy(bands))
    got = [cpu_engine.encode(strain, bands) for _ in range(3)]
    assert all(torch.equal(g, want) for g in got)
    assert cpu_engine.served_encoder is None


@pytest.mark.parametrize("cls, names", [
    (CoherentEncoder, ENCODER_PARTS),
    (LeanStrainEncoder, tuple(n for n in ENCODER_PARTS
                              if n != "pf.encoder.geometry"))])
def test_parts_in_order_make_the_forward(cls, names):
    """Stepping the parts on one dict gives the forward's context, and no
    part reads an entry that a later part adds."""
    torch.manual_seed(4)
    enc = cls(d_model=32, n_layers=1, n_heads=4, context_dim=24,
              psd_bands=16).eval()
    strain, bands = (torch.from_numpy(a) for a in _inputs(2, 3))
    parts = enc.parts()
    assert tuple(n for n, _ in parts) == names
    x = {"strain": strain, "bands": bands}
    added = []
    with torch.no_grad():
        for _, step in parts:
            before = set(x)
            step(x)
            added.append(set(x) - before)
        want = enc(strain, bands)
    assert torch.equal(x["context"], want)
    assert added[-1] == {"context"}


# ── the device table of positions ─────────────────────────────────────────


@pytest.mark.parametrize("length, d_model", [(61, 192), (61, 32), (7, 16)])
def test_positions_equal_the_numpy_table(length, d_model):
    enc = LeanStrainEncoder(d_model=d_model, n_layers=1, n_heads=4)
    pe = enc.positions(length, "cpu")
    assert pe.dtype == torch.float32
    assert np.array_equal(pe.numpy(), sinusoidal_positions(length, d_model))
    assert enc.positions(length, torch.device("cpu")) is pe   # built once


def test_positions_stay_out_of_the_state_dict():
    enc = CoherentEncoder(d_model=32, n_layers=1, n_heads=4, context_dim=24,
                          psd_bands=16)
    before = set(enc.state_dict())
    with torch.no_grad():
        enc(*(torch.from_numpy(a) for a in _inputs(1, 5)))
    assert set(enc.state_dict()) == before
    assert not any("pos" in k for k in before)


# ── the recorder's pause ──────────────────────────────────────────────────


def test_a_paused_thread_opens_no_span_and_counts_nothing():
    with profile(activities=[ProfilerActivity.CPU]):
        with plog.span("pf.outer"):
            with plog.paused():
                with plog.span("pf.inside"):
                    plog.count("k", 5)
                with plog.paused():             # nests
                    pass
                assert plog.span("pf.x") is plog.span("pf.y")
            plog.count("k", 1)
    snap = plog.snapshot()
    assert set(snap) == {"pf.outer"}
    assert snap["pf.outer"]["counts"] == {"k": 1}


# ── on the card ───────────────────────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def release():
    return load_release(RELEASE)[:2]


@pytest.fixture
def engine(cuda_device, release):
    state_dict, cfg = release
    return InferenceEngine(state_dict, cfg, device=cuda_device)


def _eager(engine, strain, bands):
    with torch.no_grad():
        return engine.model.encode(
            torch.as_tensor(strain, device=engine.device),
            torch.as_tensor(bands, device=engine.device))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 1])
def test_card_replay_is_bit_equal_to_eager(engine, b):
    """First call eager, second captures, later ones replay: each context
    equal to the eager forward's bit for bit, for two inputs in turn (the
    static buffers are refreshed)."""
    a, c = _inputs(b, 10 + b), _inputs(b, 20 + b)
    want_a, want_c = _eager(engine, *a), _eager(engine, *c)
    assert not torch.equal(want_a, want_c)
    key = eg.shape_key(*a)
    got = [engine.encode(*a)]
    assert engine.served_encoder.policy.get(key) is None        # eager
    got += [engine.encode(*a)]
    assert engine.served_encoder.policy.get(key) is not None    # captured
    got += [engine.encode(*c), engine.encode(*a), engine.encode(*c)]
    for g, w in zip(got, [want_a, want_a, want_c, want_a, want_c]):
        assert g.shape == (b, 256) and g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_card_held_contexts_are_distinct(engine):
    a, c = _inputs(8, 30), _inputs(8, 31)
    engine.encode(*a)
    engine.encode(*a)
    held = [engine.encode(*a), engine.encode(*c)]
    assert held[0].data_ptr() != held[1].data_ptr()
    assert torch.equal(held[0], _eager(engine, *a))
    assert torch.equal(held[1], _eager(engine, *c))


@pytest.mark.cuda
def test_card_training_calls_with_gradients_bypass_the_graphs(engine):
    """Training calls the model with gradients, as often as it likes: the
    engine's graphs never see those calls, and the engine's own calls of
    the same shape still start eager."""
    x = _inputs(8, 32)
    s, b = (torch.as_tensor(a, device=engine.device) for a in x)
    with torch.enable_grad():
        for _ in range(3):
            assert engine.model.encode(s, b).requires_grad
    assert engine.served_encoder.policy.step(eg.shape_key(*x)) == eg.EAGER


def _profiled_encode(engine, inputs):
    torch.cuda.synchronize()
    plog.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ctx = engine.encode(*inputs)
        torch.cuda.synchronize()
    return ctx, plog.snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("calls_before, way", [
    (0, "encoder_eager"), (1, "encoder_graph_capture"),
    (2, "encoder_graph_replay")])
def test_card_spans_of_each_way(engine, calls_before, way):
    """Under a profiler each way records the five parts once inside
    `pf.encoder`, its own count there, and the strain and bands copies in
    `pf.npe.encode`; `pf.encoder.stem` copies nothing (the positions are
    made on the card once)."""
    x = _inputs(8, 40)
    for _ in range(calls_before):
        engine.encode(*x)
    ctx, snap = _profiled_encode(engine, x)
    assert torch.equal(ctx, _eager(engine, *x))
    assert {n: (snap[n]["calls"], snap[n]["parents"])
            for n in ENCODER_PARTS} == {
        n: (1, {"pf.encoder": 1}) for n in ENCODER_PARTS}
    assert snap["pf.encoder"]["parents"] == {"pf.npe.encode": 1}
    assert snap["pf.encoder"]["counts"] == {way: 1}
    assert snap["pf.npe.encode"]["counts"] == {
        "h2d_pageable": 2, "h2d_pageable_bytes": 8 * 3 * (T + 16) * 4}
    assert snap["pf.encoder.stem"]["counts"] == {}
    assert all(snap[n]["device_ms"] is not None for n in ENCODER_PARTS)
