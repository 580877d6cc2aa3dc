"""Reduced-order SVD basis for whitened FD waveforms.

Port of posteriflow_tpu/models/svd_basis.py: whitened plus-polarization
waveforms over log-uniform BBH masses with random time-shift phase ramps,
normalized, and their complex SVD; the leading right singular vectors
are the basis (saved as Bre / Bim / singular_values in an .npz).

The random draws (`draw_svd_inputs`, from an explicit generator) are split
from the waveforms (`svd_waveforms`) and the basis, so that a test can
hand over JAX's draws. The waveform stack is built on the device,
batched over the waveforms; the SVD runs on the host in complex128 numpy.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from posteriflow_torch.physics.constants import FREQS
from posteriflow_torch.physics.psd import aligo_psd, asd_from_psd
from posteriflow_torch.physics.waveforms import imr_polarizations
from posteriflow_torch.physics.whiten import whiten_fd


class SvdDraws(NamedTuple):
    m1: torch.Tensor       # [N] primary mass [Msun], m1 >= m2
    m2: torch.Tensor       # [N]
    dt: torch.Tensor       # [N] time shift [s]


def draw_svd_inputs(n_waveforms: int = 512, mass_range=(5.0, 100.0),
                    time_shift_max: float = 1.5,
                    generator: Optional[torch.Generator] = None,
                    device="cuda") -> SvdDraws:
    """Log-uniform component masses (ordered m1 >= m2) and uniform time
    shifts in [-time_shift_max, time_shift_max], float32 on `device`."""
    lo, hi = math.log(mass_range[0]), math.log(mass_range[1])
    logm = lo + (hi - lo) * torch.rand((n_waveforms, 2), generator=generator,
                                       device=device)
    m = torch.exp(logm)
    dt = (-time_shift_max + 2.0 * time_shift_max
          * torch.rand((n_waveforms,), generator=generator, device=device))
    return SvdDraws(torch.maximum(m[:, 0], m[:, 1]),
                    torch.minimum(m[:, 0], m[:, 1]), dt)


def svd_waveforms(draws: SvdDraws, asd: torch.Tensor) -> torch.Tensor:
    """Whitened h₊ [N, N_RFFT] complex64 of the draws (d_L 500 Mpc, no
    spin, face-on, phase 0), each shifted by its dt through mod-1 cycles,
    on the draws' device."""
    dev = draws.m1.device
    freqs = torch.as_tensor(np.asarray(FREQS, np.float32), device=dev)
    zero = torch.zeros_like(draws.m1)[:, None]
    hp, _ = imr_polarizations(freqs, draws.m1[:, None], draws.m2[:, None],
                              zero, zero, zero + 500.0, zero, zero)
    ang = (-2.0 * math.pi) * torch.remainder(freqs * draws.dt[:, None], 1.0)
    ramp = torch.complex(torch.cos(ang), torch.sin(ang))
    return whiten_fd(hp * ramp, asd)


def build_svd_basis(n_waveforms: int = 512, n_basis: int = 64,
                    mass_range=(5.0, 100.0), time_shift_max: float = 1.5,
                    seed: int = 0, out: Optional[str | Path] = None,
                    device="cuda", draws: Optional[SvdDraws] = None):
    """-> (basis [n_basis, N_RFFT] complex64, singular values). The draws
    come from a generator on `device` seeded with `seed`, unless given.
    With `out`, the basis is saved as JAX saves it (Bre, Bim,
    singular_values)."""
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        draws = draw_svd_inputs(n_waveforms, mass_range, time_shift_max,
                                gen, device)
    asd = asd_from_psd(aligo_psd(FREQS), device=draws.m1.device)
    with torch.no_grad():
        hw = svd_waveforms(draws, asd).cpu().numpy().astype(np.complex128)
    hw = hw / np.maximum(np.linalg.norm(hw, axis=1, keepdims=True), 1e-12)
    _, s, vh = np.linalg.svd(hw, full_matrices=False)
    basis, s = vh[:n_basis].astype(np.complex64), s[:n_basis]
    if out:
        np.savez(out, Bre=basis.real, Bim=basis.imag, singular_values=s)
    return basis, s


def project_onto_basis(h_fd: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Whitened FD strain [..., F] -> basis coefficients as stacked
    (real, imaginary) floats [..., 2·n_basis]: complex inner products
    with the conjugated basis [n_basis, F]."""
    basis = torch.as_tensor(basis, device=h_fd.device)
    coeff = torch.einsum("...f,bf->...b", h_fd, torch.conj(basis))
    return torch.cat([coeff.real, coeff.imag], dim=-1)


def load_svd_basis(path: str | Path) -> np.ndarray:
    """A saved basis (Bre, Bim) -> [n_basis, F] complex64 numpy."""
    d = np.load(path)
    return (d["Bre"] + 1j * d["Bim"]).astype(np.complex64)
