"""Context-space out-of-distribution scoring + confidence verdict.

Reference semantics (src/ahsd/inference/ood.py): fit mean + Ledoit-Wolf-
shrunk inverse covariance + an empirical distance CDF on validation
contexts; score = Mahalanobis distance, reported as a percentile against
the validation distribution; the verdict aggregates OOD percentile,
railing fraction, and data-quality warnings into HIGH/MEDIUM/LOW.

A numpy copy of the scoring half of posteriflow_tpu/inference/ood.py; the
statistics are fitted by the JAX package and shipped in each release's
ood_stats.npz.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ContextStats:
    mean: np.ndarray            # [C]
    precision: np.ndarray       # [C, C] shrunk inverse covariance
    val_dists: np.ndarray       # sorted Mahalanobis distances of val set

    @classmethod
    def load(cls, path):
        d = np.load(path)
        return cls(d["mean"], d["precision"], d["val_dists"])


def _mahalanobis(x, mean, precision):
    c = x - mean
    return np.sqrt(np.maximum(np.einsum("nc,cd,nd->n", c, precision, c), 0.0))


def score_context(stats: ContextStats, context: np.ndarray):
    """-> (distance, percentile vs validation distribution)."""
    x = np.atleast_2d(np.asarray(context, dtype=np.float64))
    d = _mahalanobis(x, stats.mean, stats.precision)
    pct = np.searchsorted(stats.val_dists, d) / max(len(stats.val_dists), 1) \
        * 100.0
    return d, pct


def confidence_verdict(ood_percentile: float, railing_frac: float,
                       quality_warnings: Sequence[str]) -> str:
    """HIGH/MEDIUM/LOW aggregation (reference thresholds: ood.py:82-113)."""
    flags = 0
    if ood_percentile >= 99.0:
        flags += 2
    elif ood_percentile >= 95.0:
        flags += 1
    if railing_frac >= 0.20:
        flags += 2
    elif railing_frac >= 0.05:
        flags += 1
    flags += min(len(quality_warnings), 2)
    if flags == 0:
        return "HIGH"
    if flags <= 2:
        return "MEDIUM"
    return "LOW"
