"""Post-hoc affine output calibration y = g·x + b for PriorityNet scores.

Port of posteriflow_tpu/core/calibrator.py (numpy, fitted on the host on
(score, target) pairs; "learned" least squares, "minmax" or "percentile").
The learned affine also lives inside PriorityNet (cal_gain / cal_bias);
this is the offline fitting utility.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class OutputCalibrator:
    gain: float = 1.0
    bias: float = 0.0
    mode: str = "learned"

    def fit(self, scores: np.ndarray, targets: np.ndarray,
            mode: str = "learned"):
        s = np.asarray(scores, dtype=np.float64).ravel()
        t = np.asarray(targets, dtype=np.float64).ravel()
        if mode == "minmax":
            s_rng = max(s.max() - s.min(), 1e-12)
            t_rng = max(t.max() - t.min(), 1e-12)
            self.gain = t_rng / s_rng
            self.bias = t.min() - self.gain * s.min()
        elif mode == "percentile":
            lo_s, hi_s = np.percentile(s, [5, 95])
            lo_t, hi_t = np.percentile(t, [5, 95])
            self.gain = (hi_t - lo_t) / max(hi_s - lo_s, 1e-12)
            self.bias = lo_t - self.gain * lo_s
        else:                              # least-squares "learned"
            a = np.vstack([s, np.ones_like(s)]).T
            self.gain, self.bias = np.linalg.lstsq(a, t, rcond=None)[0]
        self.mode = mode
        return self

    def __call__(self, scores: np.ndarray) -> np.ndarray:
        return self.gain * np.asarray(scores) + self.bias
