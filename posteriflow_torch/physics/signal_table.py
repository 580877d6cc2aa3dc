"""The simulator's waveforms in two parts: a per-signal table and a per-bin
evaluation.

`waveform_table(params [N, P])` gathers every per-signal constant that a
bin's evaluation needs into one float32 table [N, C], its columns named
by COLUMNS: PhenomD's λ fits, joins and amplitude collocation, TaylorF2's
series, the matter taper and tidal phase, the aligned spins and χ_p, and
each detector's response and time shift. A batch builds it once and both
of the simulator's passes read it. `coarse_twist` makes the precessing
twist (SP, SM) on its chirp-adapted coarse grid.

`white_fd_plain` and `snr_plain` evaluate the whitened waveforms and the
amplitude-only SNR from the table, bin by bin, with the same operations
in the same order as the waveform functions (physics/waveforms/): the
plain versions of csrc/waveform.cu's kernels, and the path of every CPU
call. `signal_white_fd` and `signal_snr_amp_only` (physics/simulator.py)
are these on a fresh table.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from posteriflow_torch.physics.constants import (DELTA_F, DURATION, FREQS,
                                                 N_DETECTORS)
from posteriflow_torch.physics.projection import (GMST_REF, OMEGA_EARTH,
                                                  network_response)
from posteriflow_torch.physics.waveforms.phenomd import (_LAM_NAMES,
                                                         PhenomDCoeffs)
from posteriflow_torch.physics.waveforms.precession import (
    TwistGrid, spin_components, twist_factors, twist_grid, twist_up)
from posteriflow_torch.physics.waveforms.taylorf2 import TaylorF2Coeffs
from posteriflow_torch.physics.waveforms.tidal import (MatterCoeffs,
                                                       PhenomDMatterCoeffs,
                                                       phenomd_matter_coeffs,
                                                       phenomd_matter_eval)
from posteriflow_torch.utils.constants import device_constant

FREQS_NP = np.asarray(FREQS, dtype=np.float32)
SQRT_4DF = float(np.sqrt(4.0 * DELTA_F))
# the twist's coarse grid keeps every 8th point of the grid it serves
TWIST_DECIMATE = 8

_TF2 = ("pim", "k", "eta128", "p2", "p3", "p4", "p5", "p6", "p7", "twophi")
_AMP_INS = ("ap23", "ap1", "ap43", "ap53", "ap2")
_JOINS = ("c1_int", "c2_int", "c1_mrd", "c2_mrd")
_DETECTOR = ("tau", "fp", "fx", "w", "phi", "wsq")
COLUMNS = (_TF2 + ("m_sec", "eta", "f_rd", "f_damp", "fa3")
           + tuple(f"d{i}" for i in range(5)) + _AMP_INS + _LAM_NAMES
           + _JOINS + ("pim_t", "tidal", "f_end", "chi1z", "chi2z", "chi_p")
           + tuple(f"{q}{d}" for q in _DETECTOR for d in range(N_DETECTORS)))
COL = {name: i for i, name in enumerate(COLUMNS)}


class Twist(NamedTuple):
    """The precessing twist on a coarse grid: (SP, SM) [N, K] complex64
    and the grid that takes them to the full one."""
    sp: torch.Tensor
    sm: torch.Tensor
    grid: TwistGrid


def freqs_on(device, decimate: int = 1) -> torch.Tensor:
    """Every decimate-th bin of the float32 grid, made once per device."""
    return device_constant(("freqs", decimate), device, lambda: torch.tensor(
        FREQS_NP[::decimate]))


def response(ra, dec, psi_pol, t_off):
    """(F₊, F×, Δt) [N, n_det] at the event's sidereal time."""
    gmst = GMST_REF + OMEGA_EARTH * t_off
    return network_response(ra, dec, psi_pol, gmst)


def precessing(params: torch.Tensor) -> bool:
    """Whether params [..., P] are the precessing set (P = 15)."""
    return params.shape[-1] >= 15


def waveform_table(params: torch.Tensor) -> torch.Tensor:
    """[N, len(COLUMNS)] float32: the per-signal constants of N signals,
    params [N, P] physical (P = 11 aligned, 15 precessing). The aligned
    set's spins are its own χ₁, χ₂ (χ_p 0) and its detector columns hold
    the folded response w_d, φ_d and w_d²; the precessing set's hold F₊,
    F× (w, φ and w² zero)."""
    (m1, m2, d, ra, dec, theta_jn, psi_pol, phase_c, t_off, a1,
     a2) = params.unbind(-1)[:11]
    if precessing(params):
        t1, t2, p12 = params.unbind(-1)[11:14]
        chi_1, chi_2, chi_p = spin_components(a1, a2, t1, t2, p12, m1, m2)
    else:
        chi_1, chi_2, chi_p = a1, a2, torch.zeros_like(a1)
    c = phenomd_matter_coeffs(m1, m2, chi_1, chi_2, d, phase_c)
    pd, tf2, mat, lam = c.phenomd, c.phenomd.tf2, c.matter, c.phenomd.lam
    f_plus, f_cross, dt = response(ra, dec, psi_pol, t_off)       # [N, D]
    tau = 0.5 * DURATION + t_off[:, None] + dt
    zero = torch.zeros_like(f_plus)
    if precessing(params):
        w = phi = w2 = zero
    else:
        ci = torch.cos(theta_jn)
        wp = f_plus * (0.5 * (1.0 + ci * ci))[:, None]
        wc = f_cross * ci[:, None]
        w2 = wp * wp + wc * wc
        w = torch.sqrt(w2)
        phi = torch.atan2(wc, wp)
    cols = {
        **dict(zip(_TF2, tf2)),
        "m_sec": pd.m_sec, "eta": pd.eta, "f_rd": pd.f_rd,
        "f_damp": pd.f_damp, "fa3": pd.fa3,
        **{f"d{i}": x for i, x in enumerate(pd.deltas)},
        **dict(zip(_AMP_INS, pd.amp_ins)), **lam,
        "c1_int": pd.c1_int, "c2_int": pd.c2_int, "c1_mrd": pd.c1_mrd,
        "c2_mrd": pd.c2_mrd,
        "pim_t": mat.pim, "tidal": mat.tidal, "f_end": mat.f_end,
        "chi1z": chi_1, "chi2z": chi_2, "chi_p": chi_p,
    }
    for q, x in zip(_DETECTOR, (tau, f_plus, f_cross, w, phi, w2)):
        for k in range(N_DETECTORS):
            cols[f"{q}{k}"] = x[:, k]
    return torch.stack([cols[n] for n in COLUMNS], dim=-1)


def _col(table: torch.Tensor, name: str) -> torch.Tensor:
    """A column of the table as [N, 1], to broadcast against a grid."""
    return table[:, COL[name], None]


def _detectors(table: torch.Tensor, q: str) -> torch.Tensor:
    """The per-detector columns `q` as [N, n_det]."""
    return table[:, COL[f"{q}0"]:COL[f"{q}0"] + N_DETECTORS]


def table_coeffs(table: torch.Tensor) -> PhenomDMatterCoeffs:
    """The waveform's per-signal constants read back from the table, each
    [N, 1]."""
    c = lambda n: _col(table, n)                                # noqa: E731
    tf2 = TaylorF2Coeffs(*(c(n) for n in _TF2))
    pd = PhenomDCoeffs(tf2, c("m_sec"), c("eta"),
                       {n: c(n) for n in _LAM_NAMES}, c("f_rd"),
                       c("f_damp"), tuple(c(n) for n in _AMP_INS), c("fa3"),
                       tuple(c(f"d{i}") for i in range(5)),
                       *(c(n) for n in _JOINS))
    return PhenomDMatterCoeffs(pd, MatterCoeffs(c("pim_t"), c("tidal"),
                                                c("f_end")))


def twist_grid_of(decimate: int, f_lower: float, device) -> TwistGrid:
    """The coarse twist grid of every decimate-th bin on `device`."""
    return twist_grid(FREQS_NP[::decimate], TWIST_DECIMATE, f_lower,
                      torch.device(device))


def coarse_twist(params: torch.Tensor, table: torch.Tensor, decimate: int,
                 f_lower: float = 20.0) -> Twist:
    """The precessing twist of params [N, 15] (spins from their table) on
    the coarse grid of every decimate-th bin."""
    grid = twist_grid_of(decimate, f_lower, params.device)
    p = params[:, :, None]
    sp, sm = twist_factors(grid.freqs, p[:, 0], p[:, 1], _col(table, "chi1z"),
                           _col(table, "chi2z"), _col(table, "chi_p"),
                           p[:, 5], f_lower, alpha0=p[:, 14])
    return Twist(sp, sm, grid)


def _amp_phase(table: torch.Tensor, decimate: int, f_lower: float,
               phase: bool):
    return phenomd_matter_eval(freqs_on(table.device, decimate),
                               table_coeffs(table), f_lower, phase=phase)


def _response_d(table: torch.Tensor, twist: Twist) -> torch.Tensor:
    """The complex per-detector response [N, D, F] of the twisted
    polarizations: c_d = F₊ᵈ (SP+SM)/2 + i Fₓᵈ (SP−SM)/2."""
    sp, sm = twist_up(twist.sp, twist.grid), twist_up(twist.sm, twist.grid)
    f_plus, f_cross = _detectors(table, "fp"), _detectors(table, "fx")
    return (f_plus[..., None] * (0.5 * (sp + sm))[:, None, :]
            + 1j * f_cross[..., None] * (0.5 * (sp - sm))[:, None, :])


def white_fd_plain(table: torch.Tensor, twist: Optional[Twist],
                   asd: torch.Tensor, f_lower: float = 20.0) -> torch.Tensor:
    """Whitened per-detector FD strain [N, n_det, N_RFFT] complex64 of the
    table's signals: with `twist`, the general projection of the twisted
    polarizations, h_d = (F₊ᵈ h̃₊ + Fₓᵈ h̃ₓ) e^{-2πifτ_d} / ASD_d · √(4Δf),
    the carrier e^{-iΨ} folded into the per-detector shift; without (the
    aligned set), h₊ and hₓ share one phase series, so each detector's
    response folds into one magnitude and phase,
    h_d(f) = A(f)·W_d·e^{-i(Ψ + 2πfτ_d − φ_d)} / ASD_d · √(4Δf)."""
    amp, psi = _amp_phase(table, 1, f_lower, True)                 # [N, F]
    freqs = freqs_on(table.device)
    tau = _detectors(table, "tau")
    cycles = torch.remainder(freqs * tau[..., None], 1.0)        # [N, D, F]
    theta = psi[:, None, :] + (2.0 * math.pi) * cycles
    if twist is None:
        theta = theta - _detectors(table, "phi")[..., None]
        mag = (amp[:, None, :] * _detectors(table, "w")[..., None]
               / torch.clamp_min(asd, 1e-38)) * SQRT_4DF
        return torch.complex(mag * torch.cos(theta), mag * -torch.sin(theta))
    mag = (0.5 * amp[:, None, :] / torch.clamp_min(asd, 1e-38)) * SQRT_4DF
    carrier = torch.complex(mag * torch.cos(theta), mag * -torch.sin(theta))
    return (carrier * _response_d(table, twist)).to(torch.complex64)


def snr_plain(table: torch.Tensor, twist: Optional[Twist], asd: torch.Tensor,
              decimate: int = 1, f_lower: float = 20.0) -> torch.Tensor:
    """Network SNR [N] of the table's signals from the amplitude alone, a
    midpoint rule on every decimate-th bin scaled by decimate. The phase
    and every time shift drop out of |h_d(f)|: aligned,
    ρ² = 4Δf Σ_f A² Σ_d w_d²/ASD_d²; precessing, |h_d| = (A/2)·|c_d| (the
    e^{2iε} of the twist cancels in the modulus)."""
    amp, _ = _amp_phase(table, decimate, f_lower, False)
    inv_asd2 = 1.0 / torch.clamp_min(asd[:, ::decimate], 1e-38) ** 2
    if twist is None:
        band = torch.sum(_detectors(table, "wsq")[..., None] * inv_asd2,
                         dim=-2)                                 # [N, F/D]
        return torch.sqrt(4.0 * DELTA_F * decimate
                          * torch.sum(amp * amp * band, dim=-1))
    w2 = torch.abs(_response_d(table, twist)) ** 2             # [N, D, F/D]
    band = torch.sum(w2 * inv_asd2, dim=-2)                    # [N, F/D]
    return torch.sqrt(4.0 * DELTA_F * decimate
                      * torch.sum((0.5 * amp) ** 2 * band, dim=-1))
