"""Adaptive signal subtraction for the hierarchical decomposition (torch).

Port of posteriflow_tpu/core/subtractor.py, on one device: the template
is the posterior mean of the whitened FD waveforms of K posterior draws
(`signal_white_fd`, batched), the amplitude the closed-form least-squares
α = Re⟨d, h⟩ / ⟨h, h⟩, and the residual goes back to the time domain
through `fd_white_to_td`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from posteriflow_torch.inference.importance import data_white_fd
from posteriflow_torch.physics.simulator import design_asd, signal_white_fd
from posteriflow_torch.physics.whiten import fd_white_to_td


def mean_template(theta_draws: torch.Tensor, asd: torch.Tensor):
    """Posterior-mean whitened template [n_det, F] of draws [K, P] and the
    mean squared spread of the draws' templates about it."""
    h = signal_white_fd(theta_draws, asd)
    mean = torch.mean(h, dim=0)
    return mean, torch.mean(torch.abs(h - mean) ** 2)


def ls_fit(d_w: torch.Tensor, h: torch.Tensor):
    """(α, fit SNR, template SNR, quality) of template h against data d_w
    (whitened FD, summed over the last two axes; leading axes batch):
    α = Re⟨d, h⟩/⟨h, h⟩, fit = Re⟨d, h⟩/|h|, quality = fit/|h| in
    [-1, 2]."""
    hh = torch.sum(torch.abs(h) ** 2, dim=(-2, -1))
    dh = torch.sum(torch.real(d_w * torch.conj(h)), dim=(-2, -1))
    alpha = dh / torch.clamp_min(hh, 1e-12)
    template_snr = torch.sqrt(hh)
    fit_snr = dh / torch.clamp_min(template_snr, 1e-12)
    quality = torch.clamp(fit_snr / torch.clamp_min(template_snr, 1e-9),
                          -1.0, 2.0)
    return alpha, fit_snr, template_snr, quality


class AdaptiveSubtractor:
    def __init__(self, asd: Optional[torch.Tensor] = None,
                 quality_threshold: float = 0.3, device="cuda"):
        self.device = torch.device(device)
        self.asd = (design_asd(self.device) if asd is None
                    else torch.as_tensor(asd, device=self.device))
        self.quality_threshold = quality_threshold

    @torch.no_grad()
    def subtract(self, strain_white: np.ndarray,
                 theta_draws: np.ndarray) -> Dict:
        """Subtract one signal (posterior-mean template, LS amplitude).

        strain_white [n_det, T] whitened TD; theta_draws [K, P] posterior
        draws of the signal to remove. Returns the residual (numpy TD and
        FD on the device) and the fit's statistics."""
        dev = self.device
        d_w = data_white_fd(torch.as_tensor(strain_white, dtype=torch.float32,
                                            device=dev))
        h_mean, h_var = mean_template(torch.as_tensor(
            theta_draws, dtype=torch.float32, device=dev), self.asd)
        alpha, fit_snr, template_snr, quality = ls_fit(d_w, h_mean)
        residual_fd = d_w - alpha * h_mean
        quality = float(quality)
        return {
            "residual": fd_white_to_td(residual_fd).cpu().numpy(),
            "residual_fd": residual_fd,
            "alpha": float(alpha),
            "template_snr": float(template_snr),
            "fit_snr": float(fit_snr),
            "quality": quality,
            "template_variance": float(h_var),
            "accepted": bool(quality > self.quality_threshold),
        }
