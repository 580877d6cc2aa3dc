"""Remnant and ringdown fits that PhenomD uses, and the round-1
phenomenological IMR stitch kept as the regression baseline ("IMRPhenomJ"
in the registry). Port of posteriflow_tpu/physics/waveforms/imr.py.

The stitch: 3.5PN TaylorF2 up to f_t = f_RD/2; past it a Lorentzian ×
exponential amplitude whose decay rate makes d ln A continuous at f_t, and
the phase continued linearly plus an arctan ringdown term with matched
value and slope.
"""

from __future__ import annotations

import math

import torch

from posteriflow_torch.physics.constants import MTSUN_SI
from posteriflow_torch.physics.waveforms.taylorf2 import (polarizations,
                                                          taylorf2_amp_phase)

_ATAN_COEF = 2.0      # ringdown phase curvature scale [rad]
_LORENTZ_WIDTH = 1.0  # Lorentzian width in units of f_damp


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


def _stitch_point(f_t, tf2_args):
    """(A, Ψ, dΨ/df) of TaylorF2 at f_t [..., 1]. dΨ/df is the gradient of
    the sum over signals at a leaf that requires grad: each signal's phase
    depends on its own f_t alone. Under enable_grad, so that it also works
    inside no_grad, as every serving path runs."""
    with torch.enable_grad():
        leaf = f_t.detach().requires_grad_(True)
        amp_t, psi_t = taylorf2_amp_phase(leaf, *tf2_args)
        (dpsi_t,) = torch.autograd.grad(psi_t.sum(), leaf)
    return amp_t.detach(), psi_t.detach(), dpsi_t


def imr_stitch_polarizations(freqs, mass_1, mass_2, chi_1, chi_2,
                             luminosity_distance, theta_jn, phase_c,
                             f_lower: float = 20.0):
    """(h̃₊, h̃ₓ) [..., F] complex64 stitched IMR waveform, coalescence at
    t = 0 (posteriflow_tpu/physics/waveforms/imr.py:74); per-signal
    parameters broadcast as [N, 1]."""
    tf2_args = (mass_1, mass_2, chi_1, chi_2, luminosity_distance, phase_c,
                f_lower)
    amp_ins, psi_ins = taylorf2_amp_phase(freqs, *tf2_args)

    mf, af = final_state(mass_1, mass_2, chi_1, chi_2)
    f_rd, f_damp = qnm_frequency(mf, af)
    f_t = 0.5 * f_rd
    gw = _LORENTZ_WIDTH * f_damp
    amp_t, psi_t, dpsi_t = _stitch_point(f_t, tf2_args)

    # merger-ringdown amplitude: Lorentzian × exp decay, C¹ at f_t
    def lorentz(f):
        return gw * gw / ((f - f_rd) ** 2 + gw * gw)

    lor_t = lorentz(f_t)
    dln_lor_t = -2.0 * (f_t - f_rd) / ((f_t - f_rd) ** 2 + gw * gw)
    lam = dln_lor_t + 7.0 / (6.0 * f_t)
    amp_mr = amp_t * (lorentz(freqs) / lor_t) * torch.exp(
        -torch.clamp_min(lam, 0.0) * (freqs - f_t))

    # merger-ringdown phase: linear continuation + matched arctan term
    g = torch.atan((freqs - f_rd) / f_damp)
    g_t = torch.atan((f_t - f_rd) / f_damp)
    dg_t = f_damp / ((f_t - f_rd) ** 2 + f_damp ** 2)
    psi_mr = (psi_t + dpsi_t * (freqs - f_t)
              + _ATAN_COEF * (g - g_t - dg_t * (freqs - f_t)))

    in_mr = freqs > f_t
    amp = torch.where(in_mr, amp_mr, amp_ins)
    psi = torch.where(in_mr, psi_mr, psi_ins)
    return polarizations(amp, psi, theta_jn)
