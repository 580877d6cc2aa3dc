"""Whitening between the continuous-FT frequency domain and whitened time
samples.

Port of posteriflow_tpu/physics/whiten.py. Functions take the ASD in
scaled strain units and divide by it before anything is squared (PSDs
underflow float32). In these normalizations a whitened signal's L2 norm is
its matched-filter SNR, and whitened design noise is unit-variance.
"""

from __future__ import annotations

import math

import torch

from pfbench.reference.frozen.physics.constants import DELTA_F, N_SAMPLES


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


def fd_white_to_td(h_w_fd: torch.Tensor, n: int = N_SAMPLES) -> torch.Tensor:
    """Whitened continuous-FT FD strain [..., N_RFFT] -> whitened time
    samples [..., n]: irfft(h̃_w · sqrt(n/2))."""
    return torch.fft.irfft(_real_edge_bins(h_w_fd * math.sqrt(n / 2.0), n),
                           n=n, dim=-1)
