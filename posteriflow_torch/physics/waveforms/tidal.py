"""Matter effects: tidal phase and merger/disruption tapers keyed on mass.

Port of posteriflow_tpu/physics/waveforms/tidal.py:47-165. Each companion
gets a tidal deformability Λ(m) from a representative EOS relation, zero
above the NS maximum mass, so one branchless path serves every event type:
BBH (Λ₁ = Λ₂ = 0) is exactly PhenomD, BNS gets the tidal phase and a
contact-frequency taper, NSBH the secondary's tidal phase and a disruption
taper. The tidal phase is the 5PN + 6PN Λ̃ series.
"""

from __future__ import annotations

import math

import torch

from posteriflow_torch.physics.constants import MTSUN_SI
from posteriflow_torch.physics.waveforms.phenomd import phenomd_amp_phase
from posteriflow_torch.physics.waveforms.taylorf2 import (cbrt,
                                                          polarizations)

NS_MAX_MASS = 3.0        # Λ(m) = 0 above this (BH); prior NS boxes end at 2.5
LAMBDA_14 = 330.0        # Λ at 1.4 Msun
LAMBDA_SLOPE = -6.0      # d lnΛ / d ln m (common-radius approximation)
LAMBDA_MAX = 5000.0      # low-mass divergence guard
K2_LOVE = 0.10           # representative quadrupole Love number for R(Λ)


def lambda_from_mass(m):
    """Representative EOS tidal deformability Λ(m); 0 for BH masses."""
    lam = LAMBDA_14 * (m / 1.4) ** LAMBDA_SLOPE
    lam = torch.clamp(lam, 0.0, LAMBDA_MAX)
    return torch.where(m < NS_MAX_MASS, lam, 0.0)


def effective_lambda(m1, m2, lambda1, lambda2):
    """Λ̃, the combination the phase measures at leading order (Wade et al.
    2014 Eq. 5)."""
    mt = m1 + m2
    return (16.0 / 13.0) * ((m1 + 12.0 * m2) * m1 ** 4 * lambda1
                            + (m2 + 12.0 * m1) * m2 ** 4 * lambda2) / mt ** 5


def tidal_phase(freqs, m1, m2, lambda1, lambda2):
    """Tidal phase ψ_T(f) [rad] added to Ψ:
    3/(128 η v⁵)·[−(39/2) Λ̃ v¹⁰ − (3115/64) Λ̃ v¹²]; zero when Λ₁ = Λ₂ = 0."""
    m = (m1 + m2) * MTSUN_SI
    eta = (m1 * m2) / (m1 + m2) ** 2
    lam_t = effective_lambda(m1, m2, lambda1, lambda2)
    f = torch.clamp_min(freqs, 1.0)
    v = cbrt(math.pi * m * f)
    v2 = v * v
    v5 = v2 * v2 * v
    v7 = v5 * v2
    return -(3.0 / (128.0 * eta)) * lam_t * (
        (39.0 / 2.0) * v5 + (3115.0 / 64.0) * v7)


def ns_radius_sec(m, lam):
    """NS radius [s, geometric] from Λ = (2/3) k₂ (R/Gm)⁵; Λ = 0 → R = 0."""
    return m * MTSUN_SI * (1.5 * lam / K2_LOVE) ** 0.2


def bns_merger_frequency(m1, m2, lambda1, lambda2):
    """Contact-frequency estimate of the BNS merger GW frequency [Hz],
    capped at 1e9 (the BBH limit has no taper)."""
    m = (m1 + m2) * MTSUN_SI
    d = ns_radius_sec(m1, lambda1) + ns_radius_sec(m2, lambda2)
    d = torch.clamp_min(d, 1e-12)
    f = torch.sqrt(m / d ** 3) / math.pi
    return torch.clamp_max(f, 1e9)


def nsbh_disruption_frequency(m_bh, m_ns, lambda_ns):
    """Tidal-disruption GW frequency estimate [Hz] for an NSBH:
    d_td ≈ R_ns·(M_bh/M_ns)^⅓, converted to GW frequency by Kepler."""
    m = (m_bh + m_ns) * MTSUN_SI
    r_ns = ns_radius_sec(m_ns, lambda_ns)
    d = torch.clamp_min(
        r_ns * (m_bh / torch.clamp_min(m_ns, 0.1)) ** (1.0 / 3.0), 1e-12)
    return torch.clamp_max(torch.sqrt(m / d ** 3) / math.pi, 1e9)


def merger_taper(freqs, f_end, rolloff: float = 0.12):
    """Amplitude rolloff beyond f_end: a sigmoid in log-frequency."""
    f = torch.clamp_min(freqs, 1.0)
    x = torch.log(f / torch.clamp_min(f_end, 1.0)) / rolloff
    return 1.0 / (1.0 + torch.exp(torch.clamp(x, -30.0, 30.0)))


def matter_effects(freqs, m1, m2, phase: bool = True):
    """(ψ_T, taper) [..., F] for masses m1 ≥ m2 [Msun]; ψ_T is None when
    `phase` is False."""
    lam1 = lambda_from_mass(m1)
    lam2 = lambda_from_mass(m2)
    psi_t = tidal_phase(freqs, m1, m2, lam1, lam2) if phase else None
    f_merg = bns_merger_frequency(m1, m2, lam1, lam2)
    f_disr = nsbh_disruption_frequency(m1, m2, lam2)
    f_end = torch.minimum(f_merg, f_disr)
    return psi_t, merger_taper(freqs, f_end)


def phenomd_matter_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                             luminosity_distance, phase_c,
                             f_lower: float = 20.0, phase: bool = True):
    """(amp, psi) of PhenomD × matter effects: the tidal phase adds to Ψ and
    the taper multiplies the amplitude. With phase=False psi is None."""
    amp, psi = phenomd_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                                 luminosity_distance, phase_c, f_lower,
                                 phase=phase)
    psi_t, taper = matter_effects(freqs, mass_1, mass_2, phase=phase)
    return amp * taper, (psi + psi_t if phase else None)


def phenomd_matter_polarizations(freqs, mass_1, mass_2, chi_1, chi_2,
                                 luminosity_distance, theta_jn, phase_c,
                                 f_lower: float = 20.0):
    """(h̃₊, h̃ₓ) [..., F] complex64 of PhenomD × matter effects, the
    production approximant (posteriflow_tpu/physics/waveforms/tidal.py:168);
    for BBH masses (Λ = 0) exactly PhenomD."""
    amp, psi = phenomd_matter_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                                        luminosity_distance, phase_c,
                                        f_lower)
    return polarizations(amp, psi, theta_jn)
