"""Training-data synthesis on the device: priors → waveforms → whitened
strain.

Port of posteriflow_tpu/physics/simulator.py, with its noise bank and host
feed (`bank=`, `real_feed=`, data/noise_bank.py and data/host_feed.py):
with either given and `real_noise_prob` > 0, each event takes real noise
with that probability: a bank crop (or the feed's crop), its signals
re-coloured into that segment's whitening before the single transform to
the time domain, and asd_bands from the segment. With neither, every
event gets design Gaussian noise and asd_bands = 0.

The semantics are the JAX package's:
  - per-signal SNR is measured, never targeted; signals below min_snr are
    dropped and the survivors packed first in loudness order
    (Mc^(5/6)/d_L), with a branchless one-hot compaction and an index
    tie-break;
  - detector dropout replaces a detector with unit white noise, or on a
    real-noise event with the same crop time-flipped and negated;
  - network SNR is the L2 norm of the summed design-whitened signal over
    kept detectors, taken in the frequency domain;
  - the glitch is added after the noise is chosen (real noise gets it
    too, the dropout fill never); dropped detectors report asd_bands 0.

Every random step is split into a draw and an apply part: `draw_events`
makes the noise, fill, dropout and glitch draws (`SimDraws`) from a
torch.Generator, `draw_real` the real-noise choice and crops
(`RealDraws`), made only when a bank or feed is given and
real_noise_prob > 0 and after the others, so the Gaussian path's stream
from a seed is the same with or without a bank. `simulate_from_draws` is
deterministic given the parameters and the draws. `simulate_batch` runs the
JAX package's two passes: the amplitude-only SNR of every slot on a
decimated grid (4 for the aligned set, 2 for the precessing one), the gate,
then the full whitened waveform of every slot and the masked slot sum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from posteriflow_torch.data.noise_bank import (NoiseBank, RealNoiseDraws,
                                               draw_real_noise,
                                               real_noise_from_draws)
from posteriflow_torch.physics.constants import (DELTA_F, DURATION, F_LOWER,
                                                 FREQS, N_DETECTORS,
                                                 N_SAMPLES)
from posteriflow_torch.physics.projection import (GMST_REF, OMEGA_EARTH,
                                                  network_response)
from posteriflow_torch.physics.psd import default_network_asd
from posteriflow_torch.physics.waveforms.precession import (
    spin_components, twist_factors_decimated)
from posteriflow_torch.physics.waveforms.tidal import phenomd_matter_amp_phase
from posteriflow_torch.physics.whiten import fd_white_to_td
from posteriflow_torch.prior import PriorConfig, loudness, sample_batch
from posteriflow_torch.utils.constants import device_constant
from posteriflow_torch.utils.logging import span

_FREQS_NP = np.asarray(FREQS, dtype=np.float32)
_SQRT_4DF = float(np.sqrt(4.0 * DELTA_F))

# Non-empty proper subsets of (H1, L1, V1) kept under detector dropout
_KEEP_CONFIGS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
                 (0, 1, 1))
MAX_GLITCHES = 3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (the `sim` part of a release's
    meta.json)."""
    prior: PriorConfig = PriorConfig()
    min_snr: float = 8.0
    det_dropout: float = 0.0
    psd_bands: int = 16
    f_lower: float = F_LOWER
    add_noise: bool = True
    # per-event probability of a real-noise crop; used only when a noise
    # bank or a host feed is given (ignored without one, as in JAX)
    real_noise_prob: float = 0.0
    # per-event probability of 1..3 sine-Gaussian bursts in one detector
    glitch_prob: float = 0.0

    @property
    def max_signals(self) -> int:
        return self.prior.max_signals


def sim_config_from_dict(d: dict) -> SimConfig:
    """The `sim` part of a saved train config -> SimConfig (JSON lists back
    to tuples)."""
    def retuple(cls, kw):
        kw = dict(kw)
        for f in dataclasses.fields(cls):
            if isinstance(kw.get(f.name), list):
                kw[f.name] = tuple(kw[f.name])
        return kw
    sim = retuple(SimConfig, d)
    sim["prior"] = PriorConfig(**retuple(PriorConfig, sim["prior"]))
    return SimConfig(**sim)


class EventBatch(NamedTuple):
    """One batch, leading dim B (no leading dim for simulate_event)."""
    strain: torch.Tensor     # [B, n_det, T] whitened strain
    params: torch.Tensor     # [B, S, P] physical, loudness-ranked, dead = 0
    n_sig: torch.Tensor      # [B] int32 signals surviving the SNR gate
    net_snr: torch.Tensor    # [B] network SNR of the summed injection
    sig_snr: torch.Tensor    # [B, S] per-signal network SNR (ranked)
    asd_bands: torch.Tensor  # [B, n_det, K] sensitivity summary (0 = design)
    det_mask: torch.Tensor   # [B, n_det] 1 = detector present


class SimDraws(NamedTuple):
    """The random draws of simulate_event, leading dims [...]."""
    noise: torch.Tensor            # [..., n_det, T] N(0, 1)
    fill: torch.Tensor             # [..., n_det, T] N(0, 1) dropout fill
    drop_u: torch.Tensor           # [...] U(0, 1): dropout if < det_dropout
    keep_idx: torch.Tensor         # [...] int in [0, 6): kept subset
    glitch_u: torch.Tensor         # [...] U(0, 1): glitches if < glitch_prob
    glitch_det: torch.Tensor       # [...] int in [0, n_det)
    glitch_n: torch.Tensor         # [...] int in [1, MAX_GLITCHES]
    glitch_centers: torch.Tensor   # [..., MAX_GLITCHES] int in [0, T)
    glitch_widths: torch.Tensor    # [..., MAX_GLITCHES] U(20, 200) samples
    glitch_amps: torch.Tensor      # [..., MAX_GLITCHES] U(2, 8)


def draw_events(batch_shape, generator: Optional[torch.Generator] = None,
                device="cuda") -> SimDraws:
    """SimDraws for events of shape `batch_shape` from `generator`."""
    s = tuple(batch_shape)
    kw = dict(generator=generator, device=device)
    mg = MAX_GLITCHES
    return SimDraws(
        noise=torch.randn(s + (N_DETECTORS, N_SAMPLES), **kw),
        fill=torch.randn(s + (N_DETECTORS, N_SAMPLES), **kw),
        drop_u=torch.rand(s, **kw),
        keep_idx=torch.randint(0, len(_KEEP_CONFIGS), s, **kw),
        glitch_u=torch.rand(s, **kw),
        glitch_det=torch.randint(0, N_DETECTORS, s, **kw),
        glitch_n=torch.randint(1, mg + 1, s, **kw),
        glitch_centers=torch.randint(0, N_SAMPLES, s + (mg,), **kw),
        glitch_widths=20.0 + torch.rand(s + (mg,), **kw) * 180.0,
        glitch_amps=2.0 + torch.rand(s + (mg,), **kw) * 6.0)


class RealDraws(NamedTuple):
    """The real-noise draws of simulate_event, leading dims [...]."""
    use_u: torch.Tensor                 # [...] U(0, 1): real if < prob
    crop: Optional[RealNoiseDraws]      # the bank's crops (None: a feed)


class RealNoise(NamedTuple):
    """What simulate_from_draws takes of real noise, leading dims [...]."""
    use_u: torch.Tensor        # [...] U(0, 1): real if < real_noise_prob
    noise: torch.Tensor        # [..., n_det, T] float32 crops
    recolor: torch.Tensor      # [..., n_det, N_RFFT] re-colouring filters
    asd_bands: torch.Tensor    # [..., n_det, K] band summaries


def mixes_real_noise(cfg: "SimConfig", bank=None, real_feed=None) -> bool:
    """Whether events take real noise: a bank or a feed is given and
    real_noise_prob > 0."""
    return ((bank is not None or real_feed is not None)
            and cfg.real_noise_prob > 0.0)


def draw_real(batch_shape, generator: Optional[torch.Generator] = None,
              device="cuda", bank: Optional[NoiseBank] = None) -> RealDraws:
    """RealDraws for events of `batch_shape`: the real-noise coin, then the
    bank's crop draws (none without a bank: a host feed brings its crops)."""
    use_u = torch.rand(tuple(batch_shape), generator=generator,
                       device=device)
    crop = (None if bank is None
            else draw_real_noise(batch_shape, bank, generator))
    return RealDraws(use_u, crop)


def real_noise(real_draws: RealDraws, bank: Optional[NoiseBank] = None,
               real_feed=None) -> RealNoise:
    """The real noise of the draws: the feed's (noise, recolor, bands) if
    given, else the bank's crops."""
    with span("pf.sim.crops"):
        if real_feed is None:
            real_feed = real_noise_from_draws(bank, real_draws.crop)
        return RealNoise(real_draws.use_u, *real_feed)


def _freqs(device, decimate: int = 1) -> torch.Tensor:
    return device_constant(("freqs", decimate), device, lambda: torch.tensor(
        _FREQS_NP[::decimate]))


def design_asd(device) -> torch.Tensor:
    """physics.psd.default_network_asd on `device`, made once."""
    return device_constant("design_asd", device,
                           lambda: default_network_asd(device="cpu"))


def _unpack(params: torch.Tensor):
    """[N, P] -> columns [N, 1] (each broadcasts against a grid [F])."""
    return [c[:, None] for c in params.unbind(-1)]


def _amp_phase(freqs, params: torch.Tensor, f_lower: float, phase: bool):
    """PhenomD × matter (amp, psi) [N, F] of aligned-spin params [N, 11]."""
    c = _unpack(params)
    return phenomd_matter_amp_phase(freqs, c[0], c[1], c[9], c[10], c[2],
                                    c[7], f_lower, phase=phase)


def _response(ra, dec, psi_pol, t_off):
    """(F₊, F×, Δt) [N, n_det] at the event's sidereal time."""
    gmst = GMST_REF + OMEGA_EARTH * t_off
    return network_response(ra, dec, psi_pol, gmst)


def signal_white_fd(params: torch.Tensor, asd: torch.Tensor,
                    f_lower: float = F_LOWER) -> torch.Tensor:
    """Whitened per-detector FD strain [N, n_det, N_RFFT] complex64 of N
    signals, params [N, P] physical (P = 11 aligned, 15 precessing). In this
    normalization a detector's optimal SNR is the L2 norm over bins.

    Aligned set: h₊ and hₓ share one phase series, so each detector's
    response folds into one magnitude and phase,
    h_d(f) = A(f)·W_d·e^{-i(Ψ + 2πfτ_d − φ_d)} / ASD_d · √(4Δf)."""
    if params.shape[-1] >= 15:
        return _signal_white_fd_prec(params, asd, f_lower)
    (m1, m2, d, ra, dec, theta_jn, psi_pol, phase, t_off, a1,
     a2) = params.unbind(-1)
    freqs = _freqs(params.device)
    amp, psi = _amp_phase(freqs, params, f_lower, True)             # [N, F]
    ci = torch.cos(theta_jn)
    f_plus, f_cross, dt = _response(ra, dec, psi_pol, t_off)        # [N, D]
    wp = f_plus * (0.5 * (1.0 + ci * ci))[:, None]
    wc = f_cross * ci[:, None]
    w = torch.sqrt(wp * wp + wc * wc)
    phi_d = torch.atan2(wc, wp)
    tau = 0.5 * DURATION + t_off[:, None] + dt
    cycles = torch.remainder(freqs * tau[..., None], 1.0)         # [N, D, F]
    theta = psi[:, None, :] + (2.0 * math.pi) * cycles - phi_d[..., None]
    mag = (amp[:, None, :] * w[..., None] / torch.clamp_min(asd, 1e-38)) \
        * _SQRT_4DF
    return torch.complex(mag * torch.cos(theta), mag * -torch.sin(theta))


def _twist_response(params: torch.Tensor, decimate: int, f_lower: float,
                    phase: bool):
    """Shared front of the precessing paths: (amp, psi [N, F], the complex
    per-detector response c_d [N, D, F], Δt [N, D]) with
    c_d = F₊ᵈ (SP+SM)/2 + i Fₓᵈ (SP−SM)/2."""
    (m1, m2, d, ra, dec, theta_jn, psi_pol, phase_c, t_off, a1, a2,
     t1, t2, p12, pjl) = _unpack(params)
    chi_1z, chi_2z, chi_p = spin_components(a1, a2, t1, t2, p12, m1, m2)
    freqs = _freqs(params.device, decimate)
    amp, psi = phenomd_matter_amp_phase(freqs, m1, m2, chi_1z, chi_2z, d,
                                        phase_c, f_lower, phase=phase)
    sp, sm = twist_factors_decimated(_FREQS_NP[::decimate], m1, m2, chi_1z, chi_2z, chi_p,
                                     theta_jn, f_lower, alpha0=pjl,
                                     decimate=8)
    f_plus, f_cross, dt = _response(params[:, 3], params[:, 4],
                                    params[:, 6], params[:, 8])
    c_d = (f_plus[..., None] * (0.5 * (sp + sm))[:, None, :]
           + 1j * f_cross[..., None] * (0.5 * (sp - sm))[:, None, :])
    return amp, psi, c_d, dt


def _signal_white_fd_prec(params: torch.Tensor, asd: torch.Tensor,
                          f_lower: float = F_LOWER) -> torch.Tensor:
    """Whitened FD strain [N, n_det, N_RFFT] of N precessing signals,
    params [N, 15]: the general projection of the twisted polarizations,
    h_d = (F₊ᵈ h̃₊ + Fₓᵈ h̃ₓ) e^{-2πifτ_d} / ASD_d · √(4Δf), with the
    carrier e^{-iΨ} folded into the per-detector shift."""
    amp, psi, c_d, dt = _twist_response(params, 1, f_lower, True)
    freqs = _freqs(params.device)
    tau = 0.5 * DURATION + params[:, 8, None] + dt
    cycles = torch.remainder(freqs * tau[..., None], 1.0)
    theta = psi[:, None, :] + (2.0 * math.pi) * cycles
    mag = (0.5 * amp[:, None, :] / torch.clamp_min(asd, 1e-38)) * _SQRT_4DF
    carrier = torch.complex(mag * torch.cos(theta), mag * -torch.sin(theta))
    return (carrier * c_d).to(torch.complex64)


def _signal_snr_prec(params: torch.Tensor, asd: torch.Tensor,
                     f_lower: float = F_LOWER,
                     decimate: int = 1) -> torch.Tensor:
    """Network SNR [N] of precessing signals without the phase chain:
    |h_d| = (A/2)·|c_d| (the e^{2iε} of the twist cancels in the modulus);
    a midpoint rule on every decimate-th bin."""
    amp, _, comb, _ = _twist_response(params, decimate, f_lower, False)
    w2 = torch.abs(comb) ** 2                                  # [N, D, F/D]
    inv_asd2 = 1.0 / torch.clamp_min(asd[:, ::decimate], 1e-38) ** 2
    band = torch.sum(w2 * inv_asd2, dim=-2)                    # [N, F/D]
    return torch.sqrt(4.0 * DELTA_F * decimate
                      * torch.sum((0.5 * amp) ** 2 * band, dim=-1))


def signal_snr_amp_only(params: torch.Tensor, asd: torch.Tensor,
                        f_lower: float = F_LOWER,
                        decimate: int = 1) -> torch.Tensor:
    """Network SNR [N] of N signals from the amplitude alone: the phase and
    every time shift drop out of |h_d(f)| = A(f)·w_d, so
    ρ² = 4Δf Σ_f A² Σ_d w_d²/ASD_d², taken on every decimate-th bin and
    scaled by decimate."""
    if params.shape[-1] >= 15:
        return _signal_snr_prec(params, asd, f_lower, decimate)
    (m1, m2, d, ra, dec, theta_jn, psi_pol, phase, t_off, a1,
     a2) = params.unbind(-1)
    amp, _ = _amp_phase(_freqs(params.device, decimate), params, f_lower,
                        False)
    ci = torch.cos(theta_jn)
    f_plus, f_cross, _ = _response(ra, dec, psi_pol, t_off)
    w2 = ((f_plus * (0.5 * (1.0 + ci * ci))[:, None]) ** 2
          + (f_cross * ci[:, None]) ** 2)                       # [N, D]
    inv_asd2 = 1.0 / torch.clamp_min(asd[:, ::decimate], 1e-38) ** 2
    band = torch.sum(w2[..., None] * inv_asd2, dim=-2)          # [N, F/D]
    return torch.sqrt(4.0 * DELTA_F * decimate
                      * torch.sum(amp * amp * band, dim=-1))


def _gate_from_snr(params: torch.Tensor, snr_orig: torch.Tensor,
                   n_sig: torch.Tensor, min_snr: float):
    """Loudness-sort, SNR-gate and compact the signal slots of events from
    per-slot SNR alone. params [..., S, P], snr_orig [..., S] (slot order),
    n_sig [...]. Returns (params_ranked, keep_orig [..., S] float,
    snr_ranked, n_valid int32): survivors packed first in loudness order,
    dead slots zero, the keep mask in the original slot order.

    Ranks come from pairwise comparison counts (descending loudness, ties
    to the lower index) and the compaction from a keep-gated prefix count;
    the one-hot selection is a product and sum, never a matmul, so each
    survivor is copied exactly."""
    s = params.shape[-2]
    idx = torch.arange(s, device=params.device)
    loud = loudness(params[..., 0], params[..., 1], params[..., 2])
    li, lj = loud[..., :, None], loud[..., None, :]
    gt = (lj > li) | ((lj == li) & (idx[None, :] < idx[:, None]))
    rank = gt.sum(-1)                                   # [..., S]
    keep = (rank < n_sig[..., None]) & (snr_orig >= min_snr)
    n_valid = keep.sum(-1).to(torch.int32)
    pos = (keep[..., None, :] & (rank[..., None, :] < rank[..., :, None])
           ).sum(-1)
    onehot = (keep[..., :, None] & (pos[..., :, None] == idx)
              ).to(params.dtype)                        # [..., S_in, S_out]
    params_r = (onehot[..., None] * params[..., :, None, :]).sum(-3)
    snr_r = (onehot * snr_orig[..., :, None]).sum(-2)
    return params_r, keep.to(torch.float32), snr_r, n_valid


def _glitch_burst(draws: SimDraws, prob: float) -> torch.Tensor:
    """[..., n_det, T] sine-Gaussian bursts (2-8σ, 20-200 samples wide) in
    one detector, present with probability `prob`."""
    fire = (draws.glitch_u < prob).to(torch.float32)
    dev = draws.noise.device
    t = torch.arange(N_SAMPLES, dtype=torch.float32, device=dev)
    live = ((torch.arange(MAX_GLITCHES, device=dev)
             < draws.glitch_n[..., None]).to(torch.float32)
            * fire[..., None])                                   # [..., G]
    c = draws.glitch_centers.to(torch.float32)[..., None]
    w = draws.glitch_widths[..., None]
    a = draws.glitch_amps[..., None]
    x = t - c                                                    # [..., G, T]
    env = torch.exp(-x ** 2 / (2.0 * (w / 3.0) ** 2))
    burst = torch.sum(live[..., None] * a * env
                      * torch.sin((2.0 * math.pi) * x / w), dim=-2)
    det = (torch.arange(N_DETECTORS, device=dev)
           == draws.glitch_det[..., None])                       # [..., D]
    return burst[..., None, :] * det[..., None]


def simulate_from_draws(pre, draws: SimDraws, cfg: SimConfig,
                        real: Optional[RealNoise] = None) -> EventBatch:
    """Assemble whitened 3-detector events from the gated waveform sum
    `pre` = (params_ranked, sig_fd [..., D, F], snr_ranked, n_valid) and
    the draws; deterministic. With `real`, an event whose use_u is below
    cfg.real_noise_prob takes the real crop as its noise, the crop
    time-flipped and negated as its dropout fill, its signal spectrum
    times the segment's filter, and the segment's asd_bands."""
    with span("pf.sim.assemble"):
        params, sig_fd, sig_snr, n_valid = pre
        dev = sig_fd.device
        keep_cfgs = device_constant("keep_configs", dev, lambda: torch.tensor(
            _KEEP_CONFIGS, dtype=torch.float32))
        drop = draws.drop_u < cfg.det_dropout
        det_mask = torch.where(drop[..., None], keep_cfgs[draws.keep_idx],
                               torch.ones(N_DETECTORS, device=dev))

        # network SNR over kept detectors, in FD with the one-sided DC and
        # Nyquist half-weights
        e_det = (torch.sum(torch.abs(sig_fd) ** 2, dim=-1)
                 - 0.5 * torch.abs(sig_fd[..., 0]) ** 2
                 - 0.5 * torch.abs(sig_fd[..., -1]) ** 2)
        net_snr = torch.sqrt(torch.sum(det_mask * e_det, dim=-1))

        noise, fill = draws.noise, draws.fill
        asd_bands = torch.zeros(det_mask.shape + (cfg.psd_bands,),
                                dtype=torch.float32, device=dev)
        if real is not None:
            use = (real.use_u < cfg.real_noise_prob)[..., None]     # [..., 1]
            noise = torch.where(use[..., None], real.noise, noise)
            fill = torch.where(use[..., None], -real.noise.flip(-1), fill)
            # re-colouring is diagonal in frequency: it folds into the
            # spectrum before the one transform to the time domain
            sig_fd = torch.where(use[..., None], sig_fd * real.recolor,
                                 sig_fd)
            asd_bands = torch.where(use[..., None], real.asd_bands,
                                    asd_bands)
        sig_td = fd_white_to_td(sig_fd, N_SAMPLES)             # [..., D, T]
        if cfg.glitch_prob > 0.0:
            noise = noise + _glitch_burst(draws, cfg.glitch_prob)
        if cfg.add_noise:
            strain = torch.where(det_mask[..., None] > 0, noise + sig_td,
                                 fill)
        else:
            strain = sig_td * det_mask[..., None]
        asd_bands = asd_bands * det_mask[..., None]
        return EventBatch(strain.to(torch.float32), params, n_valid,
                          net_snr.to(torch.float32), sig_snr, asd_bands,
                          det_mask)


def simulate_event(params: torch.Tensor, n_sig, asd: torch.Tensor,
                   cfg: SimConfig, draws: SimDraws,
                   bank: Optional[NoiseBank] = None, real_feed=None,
                   real_draws: Optional[RealDraws] = None) -> EventBatch:
    """One event (no leading dim) from params [S, P] (unordered), n_sig and
    the draws of one event. The gate SNR is the full waveform's norm, as in
    the JAX simulate_event without `pre`. `bank` or `real_feed` = (noise
    [D, T], recolor [D, F], bands [D, K]) mix in real noise with
    cfg.real_noise_prob (the feed takes precedence), with `real_draws`
    (RealDraws of one event) required then."""
    h_w = signal_white_fd(params, asd, cfg.f_lower)           # [S, D, F]
    snr = torch.sqrt(torch.sum(torch.abs(h_w) ** 2, dim=(-2, -1)))
    n_sig = torch.as_tensor(n_sig, device=params.device)
    params_r, keep, snr_r, n_valid = _gate_from_snr(params, snr, n_sig,
                                                    cfg.min_snr)
    sig_fd = torch.sum(keep[:, None, None] * h_w, dim=0)
    real = None
    if mixes_real_noise(cfg, bank, real_feed):
        if real_draws is None:
            raise ValueError("real-noise mixing needs real_draws")
        real = real_noise(real_draws, bank, real_feed)
    return simulate_from_draws((params_r, sig_fd, snr_r, n_valid), draws,
                               cfg, real)


def gated_signal_sum(params: torch.Tensor, n_sig: torch.Tensor,
                     asd: torch.Tensor, cfg: SimConfig):
    """The two passes of simulate_batch: the amplitude-only gate SNR of
    every slot, the gate, then every slot's whitened waveform and the
    masked slot sum. -> (params_ranked, sig_fd [B, D, F], snr_ranked,
    n_valid)."""
    with span("pf.sim.waveform"):
        b, s, p = params.shape
        flat = params.reshape(b * s, p)
        snr = signal_snr_amp_only(flat, asd, cfg.f_lower,
                                  decimate=4 if p < 15 else 2).reshape(b, s)
        params_r, keep, snr_r, n_valid = _gate_from_snr(params, snr, n_sig,
                                                        cfg.min_snr)
        h_w = signal_white_fd(flat, asd, cfg.f_lower).reshape(
            b, s, N_DETECTORS, -1)
        sig_fd = torch.sum(keep[:, :, None, None] * h_w, dim=1)
        return params_r, sig_fd, snr_r, n_valid


def simulate_batch(batch_size: int, cfg: SimConfig = SimConfig(),
                   asd: Optional[torch.Tensor] = None, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   params: Optional[torch.Tensor] = None,
                   n_sig: Optional[torch.Tensor] = None,
                   draws: Optional[SimDraws] = None,
                   bank: Optional[NoiseBank] = None, real_feed=None,
                   real_draws: Optional[RealDraws] = None) -> EventBatch:
    """A fresh batch of B = batch_size events on `device`, drawn from
    `generator` (torch's default generator of the device when None).
    `params` [B, S, P] with `n_sig` [B], and `draws`, replace the prior and
    the event draws when given. `bank` (a NoiseBank on `device`) or
    `real_feed` = (noise [B, D, T], recolor [B, D, F], bands [B, D, K])
    from data/host_feed.py mix in real noise with cfg.real_noise_prob (the
    feed takes precedence); their draws (`real_draws`, else drawn after
    the others) are made only then."""
    with span("pf.sim.batch"):
        device = torch.device(device)
        if asd is None:
            asd = design_asd(device)
        if params is None:
            with span("pf.sim.prior"):
                params, n_sig = sample_batch(batch_size, cfg.prior,
                                             generator, device)
        if draws is None:
            draws = draw_events((batch_size,), generator, device)
        real = None
        if mixes_real_noise(cfg, bank, real_feed):
            if real_draws is None:
                real_draws = draw_real((batch_size,), generator, device,
                                       None if real_feed is not None
                                       else bank)
            real = real_noise(real_draws, bank, real_feed)
        pre = gated_signal_sum(params, n_sig, asd, cfg)
        return simulate_from_draws(pre, draws, cfg, real)
