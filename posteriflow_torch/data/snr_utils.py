"""SNR regime taxonomy + priority normalization (numpy).

A copy of posteriflow_tpu/data/snr_utils.py: weak/low/medium/high/loud
regime bands, network SNR combination, regime estimation from parameters
(without generating a waveform), and the priority normalization PriorityNet
targets use.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# regime edges in network SNR
SNR_REGIMES = (
    ("weak", 0.0, 8.0),
    ("low", 8.0, 12.0),
    ("medium", 12.0, 20.0),
    ("high", 20.0, 35.0),
    ("loud", 35.0, np.inf),
)


def classify_snr_regime(snr: float) -> str:
    for name, lo, hi in SNR_REGIMES:
        if lo <= snr < hi:
            return name
    return "weak"


def network_snr(per_detector_snrs: Sequence[float]) -> float:
    """Quadrature combination of per-detector optimal SNRs."""
    a = np.asarray(per_detector_snrs, dtype=np.float64)
    return float(np.sqrt(np.sum(a * a)))


def estimate_snr_from_params(mass_1: float, mass_2: float,
                             luminosity_distance: float) -> float:
    """Waveform-free SNR estimate from the loudness scaling
    ρ ≈ ρ_ref · (Mc/Mc_ref)^{5/6} · (d_ref/d) — the same proxy the
    ranking layer uses (reference: inference/ranking.py:60-74, calibrated
    so a 15.9-Msun-chirp event at 400 Mpc has network SNR ≈ 25)."""
    mc = (mass_1 * mass_2) ** 0.6 / (mass_1 + mass_2) ** 0.2
    return float(25.0 * (mc / 15.9) ** (5.0 / 6.0)
                 * (400.0 / max(luminosity_distance, 1.0)))


def estimate_regime_from_params(mass_1: float, mass_2: float,
                                luminosity_distance: float) -> str:
    return classify_snr_regime(
        estimate_snr_from_params(mass_1, mass_2, luminosity_distance))


def normalize_priorities(snrs: Sequence[float],
                         floor: float = 0.05) -> np.ndarray:
    """Per-event priority targets in (floor, 1]: SNR / max(SNR). The
    PriorityNet training-target convention."""
    a = np.asarray(snrs, dtype=np.float64)
    if a.size == 0:
        return a
    p = a / max(a.max(), 1e-9)
    return np.maximum(p, floor)


def regime_fractions(snrs: Sequence[float]) -> Dict[str, float]:
    names = [classify_snr_regime(float(s)) for s in snrs]
    return {name: names.count(name) / max(len(names), 1)
            for name, _, _ in SNR_REGIMES}
