"""Context-space out-of-distribution scoring + confidence verdict.

Reference semantics (src/ahsd/inference/ood.py): fit mean + Ledoit-Wolf-
shrunk inverse covariance + an empirical distance CDF on validation
contexts; score = Mahalanobis distance, reported as a percentile against
the validation distribution; the verdict aggregates OOD percentile,
railing fraction, and data-quality warnings into HIGH/MEDIUM/LOW.

A numpy copy of posteriflow_tpu/inference/ood.py. The JAX package fits
the statistics with sklearn's LedoitWolf; `fit_context_stats` computes the
same estimate in numpy and scipy (the card's machine has no sklearn), so a
release the port trains ships its own ood_stats.npz.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
from scipy import linalg


@dataclasses.dataclass
class ContextStats:
    mean: np.ndarray            # [C]
    precision: np.ndarray       # [C, C] shrunk inverse covariance
    val_dists: np.ndarray       # sorted Mahalanobis distances of val set

    def save(self, path):
        np.savez(path, mean=self.mean, precision=self.precision,
                 val_dists=self.val_dists)

    @classmethod
    def load(cls, path):
        d = np.load(path)
        return cls(d["mean"], d["precision"], d["val_dists"])


def ledoit_wolf_shrinkage(xc: np.ndarray) -> float:
    """The Ledoit-Wolf shrinkage of centred data xc [N, C], as
    sklearn.covariance.ledoit_wolf_shrinkage(xc, assume_centered=True)
    computes it."""
    n, c = xc.shape
    x2 = xc ** 2
    emp_cov_trace = np.sum(x2, axis=0) / n
    mu = np.sum(emp_cov_trace) / c
    beta_ = np.sum(x2.T @ x2)
    delta_ = np.sum((xc.T @ xc) ** 2) / n ** 2
    beta = 1.0 / (c * n) * (beta_ / n - delta_)
    delta = (delta_ - 2.0 * mu * emp_cov_trace.sum() + c * mu ** 2) / c
    beta = min(beta, delta)
    return 0.0 if beta == 0 else beta / delta


def fit_context_stats(contexts: np.ndarray) -> ContextStats:
    """contexts [N, C] from validation events -> the mean, the precision of
    the Ledoit-Wolf shrunk covariance (sklearn's LedoitWolf().fit, then
    scipy.linalg.pinvh) and the sorted Mahalanobis distances of the
    contexts themselves (reference: ood.py:27-59)."""
    x = np.asarray(contexts, dtype=np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    c = x.shape[1]
    if c == 1:
        cov = np.atleast_2d((xc ** 2).mean())
    else:
        shrinkage = ledoit_wolf_shrinkage(xc)
        emp_cov = xc.T @ xc / x.shape[0]
        cov = (1.0 - shrinkage) * emp_cov
        cov.flat[::c + 1] += shrinkage * np.trace(emp_cov) / c
    precision = linalg.pinvh(cov, check_finite=False)
    d = _mahalanobis(x, mean, precision)
    return ContextStats(mean, precision, np.sort(d))


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
