"""Noise characterization: real-vs-synthetic classification features.

Port of posteriflow_tpu/evaluation/noise_analysis.py (NoiseAnalyzer):
kurtosis, spectral slope, line-noise detection, non-stationarity — the
features that separate real detector noise from stationary Gaussian.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from posteriflow_torch.physics.constants import SAMPLE_RATE


class NoiseAnalyzer:
    def analyze(self, strain: np.ndarray,
                sample_rate: int = SAMPLE_RATE) -> Dict:
        """strain [T] (whitened or raw) -> feature dict + verdict."""
        from scipy.stats import kurtosis
        x = np.asarray(strain, dtype=np.float64)
        x = x - x.mean()

        feats: Dict = {}
        feats["kurtosis"] = float(kurtosis(x))

        # spectral slope over the analysis band (whitened Gaussian ⇒ ~0)
        f = np.fft.rfftfreq(len(x), 1.0 / sample_rate)
        p = np.abs(np.fft.rfft(x)) ** 2
        band = (f > 20) & (f < 1000)
        logf, logp = np.log(f[band]), np.log(np.maximum(p[band], 1e-60))
        feats["spectral_slope"] = float(np.polyfit(logf, logp, 1)[0])

        # line noise: narrow bins ≫ local median power
        med = np.convolve(p[band], np.ones(65) / 65, mode="same")
        lines = f[band][p[band] > 20.0 * np.maximum(med, 1e-60)]
        feats["n_lines"] = int(len(lines))
        feats["line_frequencies"] = lines[:10].round(1).tolist()

        # non-stationarity: variance of per-segment std
        nseg = 16
        seg = x[: (len(x) // nseg) * nseg].reshape(nseg, -1)
        stds = seg.std(axis=1)
        feats["nonstationarity"] = float(stds.std() / max(stds.mean(),
                                                          1e-30))

        score = 0
        if abs(feats["kurtosis"]) > 0.5:
            score += 1
        if feats["n_lines"] > 2:
            score += 1
        if feats["nonstationarity"] > 0.1:
            score += 1
        feats["looks_real"] = bool(score >= 2)
        feats["gaussianity_score"] = 3 - score
        return feats
