"""Single-spin precession: the PhenomP-style twist-up of the aligned
PhenomD(+matter) co-precessing waveform.

Port of posteriflow_tpu/physics/waveforms/precession.py. Euler
angles (α, β, ε) of the co-precessing frame from leading-order
orbit-averaged precession (cos β = (L + S_l)/|J|, dα/df = Ω_p dt/df,
dε/df = cos β dα/df, α and ε by a cumulative trapezoid), then the Wigner-D
rotation of the (2, ±2) modes projected on the −2 spin-weighted harmonics
of theta_jn. The twist is a slow envelope; the simulator evaluates it on a
chirp-adapted coarse grid (`twist_factors_decimated`) whose indices and
weights are built once per device.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from pfbench.reference.frozen.physics.constants import MTSUN_SI
from pfbench.reference.frozen.physics.waveforms.taylorf2 import cbrt


def spin_components(a1, a2, tilt_1, tilt_2, phi_12, mass_1, mass_2):
    """(chi_1z, chi_2z, chi_p): aligned components a_i cos(tilt_i) and the
    resultant effective in-plane spin on the primary,
    chi_p = |B1·S1⊥ + B2·S2⊥·e^{iφ12}| / (B1 m1²), B1 = 2 + 3q/2,
    B2 = 2 + 3/(2q), q = m2/m1 (may exceed 1 when both spins precess; the
    JAX package documents why)."""
    chi_1z = a1 * torch.cos(tilt_1)
    chi_2z = a2 * torch.cos(tilt_2)
    q = mass_2 / mass_1
    b1 = 2.0 + 1.5 * q
    b2 = 2.0 + 1.5 / q
    s1p = a1 * torch.sin(tilt_1) * mass_1 * mass_1
    s2p = a2 * torch.sin(tilt_2) * mass_2 * mass_2
    sx = b1 * s1p + b2 * s2p * torch.cos(phi_12)
    sy = b2 * s2p * torch.sin(phi_12)
    chi_p = torch.sqrt(sx * sx + sy * sy) / (b1 * mass_1 * mass_1)
    return chi_1z, chi_2z, chi_p


def precession_angles(freqs, mass_1, mass_2, chi_1, chi_2, chi_p,
                      f_lower: float = 20.0):
    """(cos_beta, alpha, epsilon) [..., F] on an ascending grid `freqs`
    [F]; alpha = epsilon = 0 at the first bin."""
    m1 = mass_1 * MTSUN_SI
    m2 = mass_2 * MTSUN_SI
    mt = m1 + m2
    eta = (m1 * m2) / (mt * mt)
    mc = mt * eta ** 0.6

    f = torch.clamp_min(freqs, 1.0)
    v = cbrt(math.pi * mt * f)

    ell = eta * mt * mt / v
    s_l = chi_1 * m1 * m1 + chi_2 * m2 * m2
    s_p = chi_p * m1 * m1
    j_tot = torch.sqrt((ell + s_l) ** 2 + s_p ** 2)
    cos_beta = (ell + s_l) / torch.clamp_min(j_tot, 1e-30)

    omega_p = (2.0 + 1.5 * m2 / m1) * j_tot * v ** 6 / mt ** 3
    dt_df = (5.0 / 96.0) * math.pi ** (-8.0 / 3.0) * mc ** (-5.0 / 3.0) \
        * f ** (-11.0 / 3.0)
    in_band = (freqs >= f_lower).to(freqs.dtype)
    dalpha_df = omega_p * dt_df * in_band

    df = torch.clamp_min(torch.diff(freqs), 1e-12)
    trap = 0.5 * (dalpha_df[..., 1:] + dalpha_df[..., :-1]) * df
    zero = torch.zeros_like(trap[..., :1])
    alpha = torch.cat([zero, torch.cumsum(trap, dim=-1)], dim=-1)
    trap_e = 0.5 * (dalpha_df[..., 1:] * cos_beta[..., 1:]
                    + dalpha_df[..., :-1] * cos_beta[..., :-1]) * df
    epsilon = torch.cat([zero, torch.cumsum(trap_e, dim=-1)], dim=-1)
    return cos_beta, alpha, epsilon


def wigner_d2_col2(cos_beta):
    """d²_{m,2}(β) for m = (-2, -1, 0, 1, 2), in half angles."""
    cb = torch.clamp(cos_beta, -1.0, 1.0)
    c = torch.sqrt(torch.clamp_min(0.5 * (1.0 + cb), 0.0))
    s = torch.sqrt(torch.clamp_min(0.5 * (1.0 - cb), 0.0))
    c2, s2 = c * c, s * s
    return (s2 * s2,
            2.0 * c * s * s2,
            math.sqrt(6.0) * c2 * s2,
            2.0 * c2 * c * s,
            c2 * c2)


def _y2_normalized(theta_jn):
    """₋₂Y_{2m}(θ, 0) / √(5/64π) for m = (-2, -1, 0, 1, 2)."""
    c = torch.cos(theta_jn)
    s = torch.sin(theta_jn)
    return ((1.0 - c) ** 2,
            2.0 * s * (1.0 - c),
            math.sqrt(6.0) * s * s,
            2.0 * s * (1.0 + c),
            (1.0 + c) ** 2)


def _expi(x):
    return torch.complex(torch.cos(x), torch.sin(x))


def twist_factors(freqs, mass_1, mass_2, chi_1, chi_2, chi_p, theta_jn,
                  f_lower: float = 20.0, alpha0=0.0):
    """(SP, SM) [..., F] complex64 with h̃₊ = h_CP (SP + SM)/2 and
    h̃ₓ = i h_CP (SP − SM)/2, h_CP = amp·e^{-iψ}/2. alpha0 (phi_jl) is the
    azimuth of L about J at the reference frequency."""
    cos_beta, alpha, eps = precession_angles(
        freqs, mass_1, mass_2, chi_1, chi_2, chi_p, f_lower)
    alpha = alpha + alpha0
    d = wigner_d2_col2(cos_beta)
    y = _y2_normalized(theta_jn)
    e_a = _expi(alpha)                               # e^{+iα}
    e_am = torch.conj(e_a)                           # e^{-iα}
    e2e = _expi(2.0 * eps)
    # e^{-imα} for m = -2..2, by products as jnp's integer powers take them
    one = torch.ones_like(e_a)
    phase = (e_a * e_a, e_a, one, e_am, e_am * e_am)
    sp = torch.zeros_like(e_a)
    sm = torch.zeros_like(e_a)
    for k, m in enumerate((-2, -1, 0, 1, 2)):
        ph = phase[k]
        sign = 1.0 if m % 2 == 0 else -1.0
        sp = sp + ph * d[k] * y[k]
        sm = sm + sign * torch.conj(ph) * d[4 - k] * y[k]
    return e2e * sp, e2e * sm


_TWIST_GRID_CACHE: dict = {}
_TWIST_GRID_DEV: Dict[tuple, tuple] = {}


def _chirp_twist_grid(freqs_np: np.ndarray, decimate: int, f_lower: float):
    """The static chirp-adapted coarse grid of the twist envelope (a copy of
    the JAX package's numpy construction): segments that equidistribute
    ∫ max(f, f_lower)^{-5/3} df, since dα/df ∝ f^{-5/3} for every event.
    Returns (idx [K] coarse bin indices, seg [n] segment of each full bin,
    w [n] linear weight) as numpy, cached."""
    n = int(freqs_np.shape[0])
    key = (n, float(freqs_np[0]), float(freqs_np[-1]), decimate,
           float(f_lower))
    hit = _TWIST_GRID_CACHE.get(key)
    if hit is not None:
        return hit
    k_target = (n - 1) // decimate + 1
    rho = np.maximum(np.asarray(freqs_np, np.float64), f_lower) ** (-5.0 / 3)
    cum = np.concatenate([[0.0], np.cumsum(0.5 * (rho[1:] + rho[:-1]))])
    levels = np.linspace(0.0, cum[-1], k_target)
    idx = np.searchsorted(cum, levels).clip(0, n - 1)
    idx[0], idx[-1] = 0, n - 1
    idx = np.unique(idx).astype(np.int32)
    seg = np.searchsorted(idx, np.arange(n), side="right") - 1
    seg = seg.clip(0, idx.shape[0] - 2).astype(np.int32)
    span = (idx[seg + 1] - idx[seg]).astype(np.float32)
    w = ((np.arange(n) - idx[seg]) / span).astype(np.float32)
    out = (idx, seg, w)
    _TWIST_GRID_CACHE[key] = out
    return out


def _twist_grid_on(freqs_np: np.ndarray, decimate: int, f_lower: float,
                   device: torch.device):
    """(coarse freqs [K], seg [n], seg + 1 [n], w [n]) tensors on `device`,
    built once per (grid, device)."""
    key = (freqs_np.shape[0], float(freqs_np[0]), float(freqs_np[-1]),
           decimate, float(f_lower), device)
    if key not in _TWIST_GRID_DEV:
        idx, seg, w = _chirp_twist_grid(freqs_np, decimate, f_lower)
        seg_t = torch.as_tensor(seg.astype(np.int64), device=device)
        _TWIST_GRID_DEV[key] = (
            torch.as_tensor(np.asarray(freqs_np, np.float32)[idx],
                            device=device),
            seg_t, seg_t + 1, torch.as_tensor(w, device=device))
    return _TWIST_GRID_DEV[key]


def twist_factors_decimated(freqs_np: np.ndarray, mass_1, mass_2, chi_1,
                            chi_2, chi_p, theta_jn, f_lower: float = 20.0,
                            alpha0=0.0, decimate: int = 8):
    """twist_factors on the ~n/decimate-point chirp-adapted grid of the
    numpy grid `freqs_np` [n], interpolated linearly back to it: (SP, SM)
    [..., n] on the parameters' device. The chord of a rotating phasor
    droops in modulus, so the modulus is interpolated on its own and
    restored."""
    fc, seg, seg1, w = _twist_grid_on(np.asarray(freqs_np), decimate,
                                      f_lower, mass_1.device)
    sp_c, sm_c = twist_factors(fc, mass_1, mass_2, chi_1, chi_2, chi_p,
                               theta_jn, f_lower, alpha0)

    def up(x_c):
        lo = x_c[..., seg]
        hi = x_c[..., seg1]
        x_u = lo + w * (hi - lo)
        m_c = torch.abs(x_c)
        m_lo = m_c[..., seg]
        m_u = m_lo + w * (m_c[..., seg1] - m_lo)
        return x_u * (m_u / torch.clamp_min(torch.abs(x_u), 1e-12))

    return up(sp_c), up(sm_c)
