"""Baseline methods for the overlap decomposition (torch).

Port of posteriflow_tpu/evaluation/benchmarks.py, on one device with the
simulator's waveform (`signal_white_fd`): loudest-first template
subtraction from candidate parameters, the same with a merger-time grid
and least-squares amplitudes, and the joint Whittle likelihood over all
candidates at once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from posteriflow_torch.inference.importance import data_white_fd
from posteriflow_torch.physics.simulator import design_asd, signal_white_fd
from posteriflow_torch.prior import loudness


def _template_fit_snr(d_w_fd: torch.Tensor, theta: torch.Tensor,
                      asd: torch.Tensor) -> torch.Tensor:
    """Matched-filter statistic [N] of templates θ [N, P] against whitened
    data [n_det, F]."""
    h_w = signal_white_fd(theta, asd)
    num = torch.sum(torch.real(d_w_fd * torch.conj(h_w)), dim=(-2, -1))
    return num / torch.clamp_min(
        torch.sqrt(torch.sum(torch.abs(h_w) ** 2, dim=(-2, -1))), 1e-9)


def _loudness_order(candidates: np.ndarray) -> np.ndarray:
    c = torch.as_tensor(np.asarray(candidates, dtype=np.float32))
    return np.argsort(-loudness(c[:, 0], c[:, 1], c[:, 2]).numpy())


class StandardHierarchicalSubtraction:
    """Loudest-first template subtraction of candidate parameter guesses."""

    def __init__(self, asd: Optional[torch.Tensor] = None, device="cuda"):
        self.device = torch.device(device)
        self.asd = (design_asd(self.device) if asd is None
                    else torch.as_tensor(asd, device=self.device))

    def _data(self, strain_white: np.ndarray) -> torch.Tensor:
        return data_white_fd(torch.as_tensor(strain_white,
                                             dtype=torch.float32,
                                             device=self.device))

    def _theta(self, candidate: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(candidate, dtype=torch.float32,
                               device=self.device)[None]

    @torch.no_grad()
    def decompose(self, strain_white: np.ndarray,
                  candidates: np.ndarray) -> Dict:
        """strain_white [3, T]; candidates [n, P] parameter guesses.
        Subtracts each candidate's template, loudest first."""
        residual = self._data(strain_white)
        extracted = []
        for idx in _loudness_order(candidates):
            theta = self._theta(candidates[idx])
            fit = float(_template_fit_snr(residual, theta, self.asd)[0])
            residual = residual - signal_white_fd(theta, self.asd)[0]
            extracted.append({"index": int(idx), "fit_snr": fit})
        return {"order": [e["index"] for e in extracted],
                "extracted": extracted,
                "residual_power": float(torch.sum(torch.abs(residual)
                                                  ** 2))}


class SimpleIterativeSubtraction(StandardHierarchicalSubtraction):
    """Refines each candidate's merger time on a local grid of ±20 ms, then
    subtracts with the closed-form least-squares amplitude (distance is not
    gridded: the amplitude error is absorbed by α)."""

    @torch.no_grad()
    def decompose(self, strain_white: np.ndarray, candidates: np.ndarray,
                  n_grid: int = 9) -> Dict:
        residual = self._data(strain_white)
        extracted = []
        dts = torch.linspace(-0.02, 0.02, n_grid, device=self.device)
        for idx in _loudness_order(candidates):
            base = self._theta(candidates[idx])
            trials = base.repeat(n_grid, 1)
            trials[:, 8] = trials[:, 8] + dts
            grid = _template_fit_snr(residual, trials, self.asd)
            k = int(torch.argmax(grid))
            best = trials[k:k + 1]
            h_w = signal_white_fd(best, self.asd)[0]
            alpha = (torch.sum(torch.real(residual * torch.conj(h_w)))
                     / torch.clamp_min(torch.sum(torch.abs(h_w) ** 2),
                                       1e-12))
            residual = residual - alpha * h_w
            extracted.append({"index": int(idx),
                              "fit_snr": float(grid[k]),
                              "alpha": float(alpha),
                              "refined_tc": float(best[0, 8])})
        return {"order": [e["index"] for e in extracted],
                "extracted": extracted,
                "residual_power": float(torch.sum(torch.abs(residual)
                                                  ** 2))}


class JointParameterEstimation:
    """The joint Whittle log-likelihood over all candidates at once."""

    def __init__(self, asd: Optional[torch.Tensor] = None, device="cuda"):
        self.device = torch.device(device)
        self.asd = (design_asd(self.device) if asd is None
                    else torch.as_tensor(asd, device=self.device))

    def make_joint_log_likelihood(self, strain_white: np.ndarray
                                  ) -> Callable:
        """-> log_l(thetas [n_sig, P]) = Re⟨d, h⟩ − ½⟨h, h⟩ of the summed
        templates, a 0-d tensor on the device."""
        d_w = data_white_fd(torch.as_tensor(strain_white,
                                            dtype=torch.float32,
                                            device=self.device))
        asd = self.asd

        def log_l(thetas) -> torch.Tensor:
            t = torch.as_tensor(thetas, dtype=torch.float32,
                                device=d_w.device)
            h = torch.sum(signal_white_fd(t, asd), dim=0)
            return (torch.sum(torch.real(d_w * torch.conj(h)))
                    - 0.5 * torch.sum(torch.abs(h) ** 2))

        return log_l
