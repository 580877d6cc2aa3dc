"""TaylorF2: 3.5PN stationary-phase inspiral amplitude and phase.

Port of posteriflow_tpu/physics/waveforms/taylorf2.py:36-134: complete
non-spinning 3.5PN phase, the leading aligned-spin terms (1.5PN β, 2PN σ,
2.5PN γ) and the Newtonian amplitude in scaled strain units;
h̃ = A e^{-iΨ}, coalescence at t = 0.
"""

from __future__ import annotations

import math

import torch

from pfbench.reference.frozen.physics.constants import (C_SI, EULER_GAMMA, MPC_SI,
                                                 MTSUN_SI, STRAIN_SCALE)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """x^{1/3} for x > 0 in float32, through float64. In float32, x.pow(1/3)
    raises x to the exponent rounded to float32 (1/3 + 1e-8), a relative
    bias of 1e-8·ln x that Ψ ∝ v⁻⁵ carries into a phase drift of 1e-2 rad
    at 20 Hz; the float64 route rounds once, within 2 float32 steps of
    jnp.cbrt."""
    return x.double().pow(1.0 / 3.0).to(x.dtype)


def isco_frequency(total_mass_msun):
    """Schwarzschild ISCO GW frequency [Hz]: f = 1/(6^{3/2} π M_sec)."""
    m_sec = total_mass_msun * MTSUN_SI
    return 1.0 / (6.0 ** 1.5 * math.pi * m_sec)


def taylorf2_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                       luminosity_distance, phase_c, f_lower: float = 20.0,
                       phase: bool = True):
    """(amp, psi) [..., F]: amplitude [scaled strain/Hz], zero below
    f_lower, and phase [rad]; psi is None when `phase` is False."""
    m1 = mass_1 * MTSUN_SI
    m2 = mass_2 * MTSUN_SI
    m = m1 + m2
    eta = (m1 * m2) / (m * m)
    mc = m * eta ** 0.6

    f = torch.clamp_min(freqs, 1.0)      # no 0^negative at DC; masked below
    v = cbrt(math.pi * m * f)
    v3 = v * v * v

    d = luminosity_distance * MPC_SI
    k = (math.sqrt(5.0 / 24.0) * math.pi ** (-2.0 / 3.0) * STRAIN_SCALE
         * C_SI) * mc ** (5.0 / 6.0) * (math.pi * m) ** (7.0 / 6.0) / d
    amp = k / (v3 * torch.sqrt(v))
    amp = torch.where(freqs >= f_lower, amp, 0.0)
    if not phase:
        return amp, None

    delta = (m1 - m2) / m
    chi_s = 0.5 * (chi_1 + chi_2)
    chi_a = 0.5 * (chi_1 - chi_2)
    v2 = v * v
    v4, v5, v6 = v2 * v2, v2 * v3, v3 * v3
    v7 = v3 * v4
    logv = torch.log(v)

    # non-spinning 3.5PN coefficients
    p0 = 1.0
    p2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    p3_ns = -16.0 * math.pi
    p4_ns = (15293365.0 / 508032.0 + 27145.0 * eta / 504.0
             + 3085.0 * eta ** 2 / 72.0)
    p5_const_ns = math.pi * (38645.0 / 756.0 - 65.0 * eta / 9.0)
    p6 = (11583231236531.0 / 4694215680.0 - 640.0 * math.pi ** 2 / 3.0
          - 6848.0 * EULER_GAMMA / 21.0
          + eta * (-15737765635.0 / 3048192.0 + 2255.0 * math.pi ** 2 / 12.0)
          + eta ** 2 * 76055.0 / 1728.0 - eta ** 3 * 127825.0 / 1296.0
          - 6848.0 / 21.0 * math.log(4.0))
    p6_log = -6848.0 / 21.0
    p7 = math.pi * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0
                    - 74045.0 * eta ** 2 / 756.0)

    # dominant aligned-spin terms
    beta = (113.0 / 3.0) * (chi_s + delta * chi_a) - (76.0 / 3.0) * eta * chi_s
    sigma = (-(721.0 / 48.0) * eta * (chi_s ** 2 - chi_a ** 2)
             + (719.0 / 96.0) * ((chi_s ** 2 + chi_a ** 2)
                                 + 2.0 * delta * chi_s * chi_a
                                 - 2.0 * eta * (chi_s ** 2 - chi_a ** 2)))
    gamma = ((732985.0 / 2268.0 - 24260.0 * eta / 81.0
              - 340.0 * eta ** 2 / 9.0) * chi_s
             + (732985.0 / 2268.0 - 140.0 * eta / 9.0) * delta * chi_a)

    p3 = p3_ns + beta
    p4 = p4_ns - 10.0 * sigma
    p5_const = p5_const_ns - gamma

    series = (p0
              + p2 * v2
              + p3 * v3
              + p4 * v4
              + p5_const * (1.0 + 3.0 * logv) * v5
              + (p6 + p6_log * logv) * v6
              + p7 * v7)
    psi = (3.0 / (128.0 * eta * v5)) * series - 2.0 * phase_c - math.pi / 4.0
    return amp, psi


def taylorf2_polarizations(freqs, mass_1, mass_2, chi_1, chi_2,
                           luminosity_distance, theta_jn, phase_c,
                           f_lower: float = 20.0):
    """(h̃₊, h̃ₓ) [..., F] complex64, coalescence at t = 0, cut at the
    Schwarzschild ISCO (posteriflow_tpu/physics/waveforms/taylorf2.py:122):
    h̃₊ = A·(1 + cos²ι)/2·e^{-iΨ}, h̃ₓ = A·cos ι·i·e^{-iΨ}."""
    amp, psi = taylorf2_amp_phase(freqs, mass_1, mass_2, chi_1, chi_2,
                                  luminosity_distance, phase_c, f_lower)
    f_isco = isco_frequency(mass_1 + mass_2)
    amp = torch.where(freqs <= f_isco, amp, 0.0)
    return polarizations(amp, psi, theta_jn)


def polarizations(amp, psi, theta_jn):
    """(h̃₊, h̃ₓ) complex64 of an aligned-spin (2, 2) amplitude and phase:
    h̃₊ = A·(1 + cos²ι)/2·e^{-iΨ}, h̃ₓ = A·cos ι·i·e^{-iΨ}."""
    ci = torch.cos(torch.as_tensor(theta_jn, device=amp.device))
    cos_p, sin_p = torch.cos(psi), torch.sin(psi)
    w_p = amp * 0.5 * (1.0 + ci * ci)
    w_c = amp * ci
    return (torch.complex(w_p * cos_p, w_p * -sin_p),
            torch.complex(w_c * sin_p, w_c * cos_p))
