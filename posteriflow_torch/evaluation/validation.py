"""Result validation: structural/range/consistency checks on pipeline
outputs.

Port of posteriflow_tpu/evaluation/validation.py (ResultValidator), numpy
on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from posteriflow_torch import PARAM_NAMES
from posteriflow_torch.scaler import RANGES


class ResultValidator:
    """Checks a PosteriorResult (or raw samples) for structural sanity,
    physical ranges, and internal consistency."""

    def validate(self, result) -> Dict:
        issues: List[str] = []
        samples = np.asarray(result.samples)

        if samples.ndim != 2 or samples.shape[1] != len(PARAM_NAMES):
            issues.append(f"samples shape {samples.shape} != (N, "
                          f"{len(PARAM_NAMES)})")
            return {"valid": False, "issues": issues}
        if not np.isfinite(samples).all():
            issues.append("non-finite samples")

        for j, name in enumerate(PARAM_NAMES):
            lo, hi, _ = RANGES[name]
            margin = 0.01 * (hi - lo)
            col = samples[:, j]
            if col.min() < lo - margin or col.max() > hi + margin:
                issues.append(f"{name} outside [{lo}, {hi}]: "
                              f"[{col.min():.3g}, {col.max():.3g}]")

        if (samples[:, 0] < samples[:, 1] - 1e-6).any():
            issues.append("mass ordering violated (m1 < m2)")

        if samples.std(axis=0).min() < 1e-9:
            issues.append("degenerate posterior (zero-variance parameter)")

        lp = getattr(result, "log_prob", None)
        if lp is not None and not np.isfinite(np.asarray(lp)).all():
            issues.append("non-finite log_prob")

        w = getattr(result, "weights", None)
        if w is not None:
            w = np.asarray(w)
            if (w < 0).any() or abs(w.sum() - 1.0) > 1e-4:
                issues.append("weights not a normalized distribution")

        return {"valid": not issues, "issues": issues,
                "n_samples": int(len(samples))}
