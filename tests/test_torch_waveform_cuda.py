"""The simulator's waveforms split into a per-signal table and a per-bin
evaluation (physics/signal_table.py), and its kernels (ops/waveform_cuda.py,
csrc/waveform.cu).

On the CPU: the table and the plain per-bin evaluation give the bits of
the unsplit code (the benchmark's frozen copy of the simulator, which the
split left as it was) for signal_white_fd, signal_snr_amp_only,
gated_signal_sum and the PhenomD × matter amplitude and phase, aligned
(P = 11) and precessing (P = 15); the kernel's column enum is the table's;
the dispatch takes the plain passes on the CPU and counts
`waveform_eager`; the wrappers refuse what the kernels do not take.

The tests marked `cuda` hold the kernels to the plain passes on the card,
at the training cell's shape (B = 1,024, S = 5) and a small ragged one,
with real-noise and dropout events in simulate_batch's batch: the gate's
n_valid and keep masks equal except for slots within 1e-5 of min_snr, the
SNR to rtol 1e-5 (wf_snr sums its bins in an order of its own), and
sig_fd and the events' strain bit for bit where the gates agree (ROADMAP
allows 2e-3 of the peak for float32 waveform phases, but the training
cell's check of its first gradient against the plain simulator moved
4-19 % for sums off by 1e-8 to 2e-7 of their peak); two launches
bit-identical; the counters and launch counts; a CUDA call under autograd
takes the plain passes. They skip without a card.

This file imports neither JAX nor the JAX package, so that it runs on the
card too (python -m pytest --noconftest tests/test_torch_waveform_cuda.py).
"""

import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pfbench.reference.frozen.physics import simulator as frozen_sim
from pfbench.reference.frozen.physics.waveforms import tidal as frozen_tidal
from pfbench.reference.frozen.physics.waveforms import \
    precession as frozen_prec
from posteriflow_torch.data.noise_bank import make_synthetic_bank
from posteriflow_torch.ops import waveform_cuda as wc
from posteriflow_torch.physics import simulator as sim
from posteriflow_torch.physics import signal_table as st
from posteriflow_torch.physics.constants import N_RFFT
from posteriflow_torch.physics.waveforms import precession, tidal
from posteriflow_torch.prior import sample_batch
from posteriflow_torch.utils import logging as plog

ROOT = Path(__file__).resolve().parents[1]
SIM = json.loads((ROOT / "pfbench/configs/npe_r7.json").read_text())[
    "config"]["sim"]
SNR_RTOL, EDGE = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def fresh_recorder():
    plog.reset()
    yield
    plog.reset()


def _batch(b, n_params, seed, device="cpu", slots=None):
    """Prior draws of the flagship's configuration: params [b, S, P] (the
    aligned set the precessing one's first 11 columns), n_sig [b]."""
    cfg = sim.sim_config_from_dict(SIM)
    g = torch.Generator(device=device).manual_seed(seed)
    params, n_sig = sample_batch(b, cfg.prior, g, device)
    if slots is not None:
        params, n_sig = params[:, :slots], torch.clamp_max(n_sig, slots)
    return params[..., :n_params].contiguous(), n_sig, cfg


# ── on the CPU ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("n_params", [11, 15], ids=["aligned", "precessing"])
@pytest.mark.parametrize("what", ["white_fd", "snr_1", "snr_2", "snr_4",
                                  "gated"])
def test_the_split_gives_the_unsplit_bits(n_params, what):
    params, n_sig, cfg = _batch(6, n_params, seed=3)
    asd = sim.design_asd("cpu")
    flat = params.reshape(-1, n_params)
    ocfg = frozen_sim.sim_config_from_dict(SIM)
    if what == "white_fd":
        got = [sim.signal_white_fd(flat, asd)]
        want = [frozen_sim.signal_white_fd(flat, asd)]
    elif what == "gated":
        got = sim.gated_signal_sum(params, n_sig, asd, cfg)
        want = frozen_sim.gated_signal_sum(params, n_sig, asd, ocfg)
    else:
        dec = int(what[-1])
        got = [sim.signal_snr_amp_only(flat, asd, decimate=dec)]
        want = [frozen_sim.signal_snr_amp_only(flat, asd, decimate=dec)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shape", ["column", "scalar", "float64"])
@pytest.mark.parametrize("phase", [True, False], ids=["phase", "amp_only"])
def test_phenomd_matter_amp_phase_keeps_its_bits(shape, phase):
    """BBH, BNS and NSBH masses; per-signal parameters as [N, 1], 0-d and
    float64 [N, 1]."""
    g = torch.Generator().manual_seed(5)
    n = 24
    m1 = torch.cat([5 + 75 * torch.rand(n, 1, generator=g),
                    1.1 + 1.4 * torch.rand(n, 1, generator=g)])
    m2 = m1 * (0.1 + 0.9 * torch.rand(2 * n, 1, generator=g))
    rest = [torch.rand(2 * n, 1, generator=g) * s + o
            for s, o in ((1.8, -0.9), (1.8, -0.9), (2000, 50), (6.28, 0))]
    args = [m1, m2, *rest]
    freqs = st.freqs_on("cpu")
    if shape == "scalar":
        args = [a[n + 3, 0] for a in args]
    elif shape == "float64":
        args, freqs = [a.double() for a in args], freqs.double()
    got = tidal.phenomd_matter_amp_phase(freqs, *args, phase=phase)
    want = frozen_tidal.phenomd_matter_amp_phase(freqs, *args, phase=phase)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (not phase)
    if phase:
        assert torch.equal(got[1], want[1])


def test_the_decimated_twist_keeps_its_bits():
    params, _, _ = _batch(4, 15, seed=8)
    c = [x[:, None] for x in params.reshape(-1, 15).unbind(-1)]
    c1, c2, cp = precession.spin_components(c[9], c[10], c[11], c[12], c[13],
                                            c[0], c[1])
    for dec in (1, 2):
        f = st.FREQS_NP[::dec]
        got = precession.twist_factors_decimated(
            f, c[0], c[1], c1, c2, cp, c[5], alpha0=c[14])
        want = frozen_prec.twist_factors_decimated(
            f, c[0], c[1], c1, c2, cp, c[5], alpha0=c[14])
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_kernel_enum_is_the_table():
    src = wc.SOURCE.read_text()
    body = re.search(r"enum Column \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"C_(\w+)", body)
    assert names == [*st.COLUMNS, "count"]
    assert st.waveform_table(_batch(2, 15, 1)[0][0]).shape == (
        5, len(st.COLUMNS))


def test_the_kernels_build_without_fast_math():
    cmd = " ".join(wc.KERNEL.command("nvcc", Path("o.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd
    assert "fast-math" not in cmd and "fast_math" not in cmd
    code = re.sub(r"//.*", "", wc.SOURCE.read_text())
    assert not re.search(r"__(sin|cos|exp|log|pow|tan|sincos)f\b", code)
    assert wc.KERNEL.path.name.startswith("libwaveform_")


def _counts():
    return plog.snapshot()["pf.sim.waveform"]["counts"]


def test_cpu_calls_take_the_plain_passes_and_count_eager():
    params, n_sig, cfg = _batch(3, 15, seed=2)
    before = wc.KERNEL.launches
    assert wc.passes(params.reshape(-1, 15)) is wc.PLAIN
    with profile(activities=[ProfilerActivity.CPU]):
        sim.gated_signal_sum(params, n_sig, sim.design_asd("cpu"), cfg)
    assert _counts() == {"waveform_eager": 1}
    assert wc.KERNEL.launches == before


def test_the_dispatch_takes_the_kernels_for_cuda_float32_alone():
    x = torch.zeros(2, 15)
    assert not wc.kernel_takes(x) and not wc.kernel_takes(x.double())
    assert wc.passes(x) is wc.PLAIN


@pytest.mark.parametrize("call", ["snr", "sum"])
def test_the_wrappers_refuse_cpu_tensors(call):
    params, _, _ = _batch(2, 15, seed=4)
    flat = params.reshape(-1, 15)
    table = st.waveform_table(flat)
    asd = sim.design_asd("cpu")
    keep = torch.ones(2, 5)
    run = {"snr": lambda: wc.KERNEL.snr(table, None, asd, 4),
           "sum": lambda: wc.KERNEL.sum(table, None, keep, asd)}[call]
    before = wc.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        run()
    assert wc.KERNEL.launches == before


def test_the_aligned_set_has_no_twist():
    params, _, _ = _batch(2, 11, seed=4)
    flat = params.reshape(-1, 11)
    table = st.waveform_table(flat)
    assert sim._twist(flat, table, 1, 20.0) is None


# ── on the card ───────────────────────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    return torch.device("cuda")


def _passes(way, params, n_sig, asd, cfg):
    """gated_signal_sum's passes by `way` (KERNEL or PLAIN) -> the per-slot
    SNR [B, S] beside gated_signal_sum's four outputs."""
    b, s, p = params.shape
    flat = params.reshape(b * s, p)
    table = st.waveform_table(flat)
    dec = 4 if p < 15 else 2
    snr = way.snr(table, sim._twist(flat, table, dec, cfg.f_lower), asd,
                  dec, cfg.f_lower).reshape(b, s)
    params_r, keep, snr_r, n_valid = sim._gate_from_snr(params, snr, n_sig,
                                                        cfg.min_snr)
    sig_fd = way.sum(table, sim._twist(flat, table, 1, cfg.f_lower),
                     keep, asd, cfg.f_lower)
    return snr, keep, (params_r, sig_fd, snr_r, n_valid)


def _hold(got, want, min_snr):
    """The card's tolerances: per-slot SNR to rtol 1e-5; the gate equal but
    for slots within 1e-5 of min_snr (their events are not compared
    further); sig_fd bit for bit."""
    snr_k, keep_k, (pr_k, sig_k, snr_rk, nv_k) = got
    snr_p, keep_p, (pr_p, sig_p, snr_rp, nv_p) = want
    assert torch.isfinite(snr_k).all() and torch.isfinite(sig_k).all()
    torch.testing.assert_close(snr_k, snr_p, rtol=SNR_RTOL, atol=0)
    edge = ((snr_p / min_snr - 1.0).abs() <= EDGE).any(-1)
    same = (keep_k == keep_p).all(-1)
    assert bool((same | edge).all())
    ok = same & ~edge
    assert torch.equal(nv_k[ok], nv_p[ok]) and torch.equal(pr_k[ok], pr_p[ok])
    torch.testing.assert_close(snr_rk[ok], snr_rp[ok], rtol=SNR_RTOL, atol=0)
    assert torch.equal(sig_k[ok], sig_p[ok])
    assert bool((sig_k[~same.logical_or(edge) | (nv_k == 0)]
                 .abs().amax() == 0) if bool((nv_k == 0).any()) else True)
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("n_params", [15, 11], ids=["precessing", "aligned"])
@pytest.mark.parametrize("b, slots", [(1024, None), (13, 3)],
                         ids=["train", "ragged"])
def test_card_kernels_against_the_plain_passes(cuda_device, n_params, b,
                                               slots):
    params, n_sig, cfg = _batch(b, n_params, seed=2 ** 31 + 97,
                                device=cuda_device, slots=slots)
    asd = sim.design_asd(cuda_device)
    got = _passes(wc.KERNEL, params, n_sig, asd, cfg)
    want = _passes(wc.PLAIN, params, n_sig, asd, cfg)
    torch.cuda.synchronize()
    ok = _hold(got, want, cfg.min_snr)
    assert int(ok.sum()) >= 0.9 * b


@pytest.mark.cuda
@pytest.mark.parametrize("n_params", [15, 11], ids=["precessing", "aligned"])
def test_card_sum_gives_the_plain_sums_bits(cuda_device, n_params):
    """At the training cell's 5 slots wf_sum gives the plain pass's bits:
    it adds in torch.sum's order, fuses the complex product as PyTorch
    does and divides by a scalar as PyTorch's reciprocal does. The cell
    holds its first gradient to the plain simulator's, and sums off by
    1e-8 to 2e-7 of their peak moved that gradient by 4-19 %."""
    params, n_sig, cfg = _batch(1024, n_params, seed=2 ** 31 + 41,
                                device=cuda_device)
    asd = sim.design_asd(cuda_device)
    flat = params.reshape(-1, n_params)
    table = st.waveform_table(flat)
    twist = sim._twist(flat, table, 1, cfg.f_lower)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    keep = (torch.rand(1024, 5, generator=g, device=cuda_device)
            < 0.6).float()
    got = wc.KERNEL.sum(table, twist, keep, asd, cfg.f_lower)
    want = wc.PLAIN.sum(table, twist, keep, asd, cfg.f_lower)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_card_simulate_batch_with_real_noise_and_dropout(cuda_device,
                                                         monkeypatch):
    """simulate_batch at the training shape, real noise on half the events
    from a synthetic bank, detector dropout and glitches (the flagship's
    configuration): the fused passes against the plain ones, the batch's
    other outputs alike."""
    params, n_sig, cfg = _batch(1024, 15, seed=2 ** 31 + 5,
                                device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    bank = make_synthetic_bank(g, n_segments=4, device=cuda_device)
    draws = sim.draw_events((1024,), g, cuda_device)
    real = sim.draw_real((1024,), g, cuda_device, bank)
    assert cfg.det_dropout > 0 and cfg.real_noise_prob > 0
    pres, runs = [], []
    gated = sim.gated_signal_sum

    def keep_pre(*a):
        pres.append(gated(*a))
        return pres[-1]

    monkeypatch.setattr(sim, "gated_signal_sum", keep_pre)
    for way in (wc.KERNEL, wc.PLAIN):
        monkeypatch.setattr(wc, "passes", lambda *a, w=way: w)
        runs.append(sim.simulate_batch(1024, cfg, device=cuda_device,
                                       params=params, n_sig=n_sig,
                                       draws=draws, bank=bank,
                                       real_draws=real))
    torch.cuda.synchronize()
    (pr_k, sig_k, snr_k, nv_k), (pr_p, sig_p, snr_p, nv_p) = pres
    real_events = real.use_u < cfg.real_noise_prob
    dropped = draws.drop_u < cfg.det_dropout
    assert bool(real_events.any()) and bool(dropped.any())
    # a gate may differ only where a slot's SNR is within EDGE of min_snr
    edge = (((snr_p / cfg.min_snr - 1.0).abs() <= EDGE)
            | ((snr_k / cfg.min_snr - 1.0).abs() <= EDGE)).any(-1)
    same = (nv_k == nv_p) & (pr_k == pr_p).all(-1).all(-1)
    assert bool((same | edge).all())
    same &= ~edge
    assert torch.equal(sig_k[same], sig_p[same])
    k, p = runs
    for name in ("det_mask", "asd_bands"):
        assert torch.equal(getattr(k, name), getattr(p, name))
    for ev in (real_events & same, dropped & same, same):
        assert bool(ev.any()) and torch.equal(k.strain[ev], p.strain[ev])
    assert torch.equal(k.net_snr[same], p.net_snr[same])


@pytest.mark.cuda
@pytest.mark.parametrize("n_params", [15, 11], ids=["precessing", "aligned"])
def test_card_launches_are_deterministic(cuda_device, n_params):
    params, n_sig, cfg = _batch(256, n_params, seed=2 ** 32 + 3,
                                device=cuda_device)
    asd = sim.design_asd(cuda_device)
    one = _passes(wc.KERNEL, params, n_sig, asd, cfg)
    two = _passes(wc.KERNEL, params, n_sig, asd, cfg)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert all(torch.equal(a, b) for a, b in zip(one[2], two[2]))


def _profiled(fn):
    torch.cuda.synchronize()
    plog.reset()
    before = wc.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = fn()
        torch.cuda.synchronize()
    return wc.KERNEL.launches - before, _counts(), out


@pytest.mark.cuda
@pytest.mark.parametrize("n_params, launches", [(15, 2), (11, 2)],
                         ids=["precessing", "aligned"])
def test_card_a_call_launches_the_kernels_and_counts_fused(
        cuda_device, n_params, launches):
    """The gate's SNR and the kept slots' sum: one launch each."""
    params, n_sig, cfg = _batch(64, n_params, seed=6, device=cuda_device)
    asd = sim.design_asd(cuda_device)
    n, counts, out = _profiled(
        lambda: sim.gated_signal_sum(params, n_sig, asd, cfg))
    assert n == launches and counts == {"waveform_fused": 1}
    assert out[1].shape == (64, 3, N_RFFT)


@pytest.mark.cuda
def test_card_grad_mode_takes_the_plain_passes(cuda_device):
    params, n_sig, cfg = _batch(8, 15, seed=7, device=cuda_device)
    params.requires_grad_(True)
    asd = sim.design_asd(cuda_device)
    n, counts, out = _profiled(
        lambda: sim.gated_signal_sum(params, n_sig, asd, cfg))
    assert n == 0 and counts == {"waveform_eager": 1}
    want = _passes(wc.PLAIN, params, n_sig, asd, cfg)[2]
    assert torch.equal(out[1], want[1])
    with torch.no_grad():
        n, counts, _ = _profiled(
            lambda: sim.gated_signal_sum(params, n_sig, asd, cfg))
    assert n == 2 and counts == {"waveform_fused": 1}
