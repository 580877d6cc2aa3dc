"""Analytic design PSDs and the device ASD.

Port of posteriflow_tpu/physics/psd.py. PSD values (~1e-47 1/Hz)
underflow float32, so they stay float64 on the host; the device sees only
the ASD, in scaled strain units (× STRAIN_SCALE), as `default_network_asd`
gives it.

aLIGO uses the broadband analytic fit
  S_n(f) = 1e-48 (0.0152 x⁻⁴ + 0.2935 x^{9/4} + 2.7951 x^{3/2}
           − 6.5080 x^{3/4} + 17.7622),  x = f / 245.4 Hz;
AdVirgo is the same family rescaled to the AdV design floor.
"""

from __future__ import annotations

import numpy as np
import torch

from pfbench.reference.frozen.physics.constants import (DETECTORS, FREQS,
                                                 STRAIN_SCALE)

PSD_FLOOR = 1e-50
PSD_CAP = 1e-38     # value assigned below the low-frequency cutoff


def _aligo_family(f: np.ndarray, f_scale: float, amp: float) -> np.ndarray:
    x = np.maximum(np.asarray(f, dtype=np.float64), 1.0) / f_scale
    s = (0.0152 * x ** -4.0 + 0.2935 * x ** 2.25 + 2.7951 * x ** 1.5
         - 6.5080 * x ** 0.75 + 17.7622)
    return amp * np.maximum(s, PSD_FLOOR / amp)


def aligo_psd(f: np.ndarray, f_cut: float = 10.0) -> np.ndarray:
    """aLIGO zero-detuned high-power design PSD [1/Hz], float64 numpy."""
    s = _aligo_family(f, 245.4, 1e-48)
    return np.where(np.asarray(f) < f_cut, PSD_CAP, s)


def advirgo_psd(f: np.ndarray, f_cut: float = 10.0) -> np.ndarray:
    """Advanced-Virgo-like design PSD: the aLIGO family rescaled to the AdV
    floor (≈2.1× aLIGO power, minimum near 270 Hz)."""
    s = _aligo_family(np.asarray(f) * (245.4 / 270.0), 245.4, 2.1e-48)
    return np.where(np.asarray(f) < f_cut, PSD_CAP, s)


def psd_for(detector: str, f: np.ndarray = FREQS) -> np.ndarray:
    return advirgo_psd(f) if detector == "V1" else aligo_psd(f)


def default_network_psd(freqs: np.ndarray = FREQS) -> np.ndarray:
    """[n_det, N_RFFT] float64 numpy design PSD stack (H1, L1, V1)."""
    return np.stack([psd_for(d, freqs) for d in DETECTORS])


def default_network_asd(freqs: np.ndarray = FREQS,
                        device="cuda") -> torch.Tensor:
    """[n_det, N_RFFT] float32 design ASDs in scaled strain units
    (× STRAIN_SCALE) on `device`: the simulator's and whitening's ASD."""
    return torch.tensor(np.sqrt(default_network_psd(freqs)) * STRAIN_SCALE,
                        dtype=torch.float32, device=device)
