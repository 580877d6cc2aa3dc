"""Remnant and ringdown fits that PhenomD uses (port of
posteriflow_tpu/physics/waveforms/imr.py:43-72)."""

from __future__ import annotations

import math

import torch

from posteriflow_torch.physics.constants import MTSUN_SI


def final_state(mass_1, mass_2, chi_1, chi_2):
    """Remnant (final_mass_msun, final_spin) from aligned-spin NR fits:
    the Rezzolla et al. 2008 spin and the zero-spin radiated-energy fit."""
    m = mass_1 + mass_2
    eta = mass_1 * mass_2 / (m * m)
    chi = (mass_1 ** 2 * chi_1 + mass_2 ** 2 * chi_2) / (m * m)
    s4, s5, t0, t2, t3 = -0.1229, 0.4537, -2.8904, -3.5171, 2.5763
    a_f = (chi + s4 * chi * chi * eta + s5 * chi * eta * eta + t0 * chi * eta
           + 2.0 * math.sqrt(3.0) * eta + t2 * eta * eta + t3 * eta ** 3)
    a_f = torch.clamp(a_f, -0.998, 0.998)
    e_rad = eta * (0.0559745 + 0.580951 * eta - 0.960673 * eta ** 2
                   + 3.35241 * eta ** 3)
    return m * (1.0 - e_rad), a_f


def qnm_frequency(final_mass_msun, final_spin):
    """(f_RD, f_damp) [Hz] of the l=m=2, n=0 quasinormal mode (Berti,
    Cardoso & Will 2006 fits)."""
    mf_sec = final_mass_msun * MTSUN_SI
    a = torch.abs(final_spin)
    omega = 1.5251 - 1.1568 * (1.0 - a) ** 0.1292
    quality = 0.7000 + 1.4187 * (1.0 - a) ** (-0.4990)
    f_rd = omega / (2.0 * math.pi * mf_sec)
    f_damp = f_rd / (2.0 * quality)
    return f_rd, f_damp
