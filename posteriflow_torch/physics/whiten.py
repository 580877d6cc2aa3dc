"""Whitening between the continuous-FT frequency domain and whitened time
samples.

Port of posteriflow_tpu/physics/whiten.py. Functions take the ASD in
scaled strain units and divide by it before anything is squared (PSDs
underflow float32). In these normalizations a whitened signal's L2 norm is
its matched-filter SNR, and whitened design noise is unit-variance.

Matched-filter SNR uses the continuous-FT normalization
ρ² = 4 df Σ_k |h̃(f_k)|² / S_n(f_k) over f ≥ f_lower. Coloured noise is a
draw of normals (`draw_noise_normals`, from an explicit generator) and a
deterministic synthesis from them (`colored_noise_from_normals`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from posteriflow_torch.physics.constants import (DELTA_F, F_LOWER, FREQS,
                                                 N_SAMPLES, SAMPLE_RATE)
from posteriflow_torch.utils.constants import device_constant


def whiten_fd(h_fd: torch.Tensor, asd: torch.Tensor,
              delta_f: float = DELTA_F) -> torch.Tensor:
    """h̃_w = (h̃ / ASD) · sqrt(4 df); ρ = ||h̃_w||₂ over rfft bins."""
    return (h_fd / torch.clamp_min(asd, 1e-38)) * math.sqrt(4.0 * delta_f)


def _real_edge_bins(x_fd: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the imaginary part of the DC bin, and of the Nyquist bin for an
    even n: a C2R transform of a real series reads only their real parts.
    pocketfft ignores them by itself; cuFFT's C2R is not documented to, so
    both devices are handed the same input."""
    keep = torch.ones(x_fd.shape[-1], dtype=torch.float32,
                      device=x_fd.device)
    keep[0] = 0.0
    if n % 2 == 0 and x_fd.shape[-1] == n // 2 + 1:
        keep[-1] = 0.0
    return torch.complex(x_fd.real, x_fd.imag * keep)


def whiten_td(strain: torch.Tensor, asd: torch.Tensor) -> torch.Tensor:
    """Whiten time-domain strain [..., N] against asd [..., N_RFFT]:
    y = irfft(rfft(x) / (ASD · sqrt(fs/2)))."""
    n = strain.shape[-1]
    x_fd = torch.fft.rfft(strain, dim=-1) / torch.clamp_min(asd, 1e-38)
    x_fd = _real_edge_bins(x_fd / math.sqrt(SAMPLE_RATE / 2.0), n)
    return torch.fft.irfft(x_fd, n=n, dim=-1)


def fd_white_to_td(h_w_fd: torch.Tensor, n: int = N_SAMPLES) -> torch.Tensor:
    """Whitened continuous-FT FD strain [..., N_RFFT] -> whitened time
    samples [..., n] in whiten_td's normalization: irfft(h̃_w · sqrt(n/2))."""
    return torch.fft.irfft(_real_edge_bins(h_w_fd * math.sqrt(n / 2.0), n),
                           n=n, dim=-1)


def _in_band(device, f_lower: float) -> torch.Tensor:
    """[N_RFFT] bool: the rfft bins at or above f_lower, on `device`."""
    return device_constant(("in_band", float(f_lower)), device,
                           lambda: torch.from_numpy(
                               np.asarray(FREQS, np.float32) >= f_lower))


def matched_filter_snr_fd(h_fd: torch.Tensor, asd: torch.Tensor,
                          f_lower: float = F_LOWER) -> torch.Tensor:
    """Optimal SNR [...] of a continuous-FT FD waveform [..., N_RFFT]:
    ρ = sqrt(4 df Σ (|h(f)|/ASD)²) over f ≥ f_lower."""
    r = torch.abs(h_fd) / torch.clamp_min(asd, 1e-38)
    integ = torch.where(_in_band(h_fd.device, f_lower), r * r, 0.0)
    return torch.sqrt(torch.clamp_min(
        4.0 * DELTA_F * torch.sum(integ, dim=-1), 0.0))


def matched_filter_snr_td(h_td: torch.Tensor, asd: torch.Tensor,
                          f_lower: float = F_LOWER) -> torch.Tensor:
    """Optimal SNR of a time-domain waveform [..., N]: its rfft over the
    sample rate (the continuous-FT normalization) into
    matched_filter_snr_fd."""
    h_fd = torch.fft.rfft(h_td, dim=-1) / SAMPLE_RATE
    return matched_filter_snr_fd(h_fd, asd, f_lower)


def network_snr_whitened(sig_white: torch.Tensor,
                         det_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Network SNR [...] of a whitened signal [..., n_det, T]: the L2 norm
    over the kept detectors (det_mask [..., n_det], 1 kept, 0 dropped)."""
    e = torch.sum(sig_white ** 2, dim=-1)
    if det_mask is not None:
        e = e * det_mask
    return torch.sqrt(torch.sum(e, dim=-1))


def draw_noise_normals(batch_shape=(), n: int = N_SAMPLES,
                       generator: Optional[torch.Generator] = None,
                       device="cuda"):
    """(re, im) [*batch_shape, n // 2 + 1] float32 standard normals on
    `device`: the random part of colored_noise_td."""
    shape = tuple(batch_shape) + (n // 2 + 1,)
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return re, im


def colored_noise_from_normals(re: torch.Tensor, im: torch.Tensor,
                               asd: torch.Tensor,
                               n: int = N_SAMPLES) -> torch.Tensor:
    """Coloured Gaussian noise [..., n] float32 with one-sided ASD
    [..., n // 2 + 1] from the normals (re, im) [..., n // 2 + 1]: FD
    synthesis with E|X[k]|² = n·fs·S_n(f_k)/2 a complex bin. The DC bin,
    and the last bin, are real with √2 its amplitude, as JAX sets them;
    _real_edge_bins then hands cuFFT's C2R the same input pocketfft
    reads."""
    amp = asd * (math.sqrt(n * SAMPLE_RATE) / 2.0)
    edge = torch.zeros(re.shape[-1], dtype=torch.bool, device=re.device)
    edge[0] = True
    edge[-1] = True
    real = torch.where(edge, re * amp * math.sqrt(2.0), re * amp)
    imag = torch.where(edge, 0.0, im * amp)
    return torch.fft.irfft(_real_edge_bins(torch.complex(real, imag), n),
                           n=n, dim=-1)


def colored_noise_td(asd: torch.Tensor, n: int = N_SAMPLES,
                     generator: Optional[torch.Generator] = None,
                     batch_shape=()) -> torch.Tensor:
    """Coloured Gaussian noise [*batch_shape, n] with one-sided ASD
    [N_RFFT] on the ASD's device: draw_noise_normals, then
    colored_noise_from_normals."""
    re, im = draw_noise_normals(batch_shape, n, generator, asd.device)
    return colored_noise_from_normals(re, im, asd, n)
