"""Posterior-against-posterior comparison for the anchor runs.

Port of the per-parameter half of posteriflow_tpu/evaluation/metrics.py
ComparisonMetrics (:294-374): compare_posteriors and summarize, numpy and
scipy on the host. The multi-method ranking (compare_methods and its
significance tests) and the other metric classes are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from posteriflow_torch import PARAM_NAMES


class ComparisonMetrics:
    """Pairwise method comparison on shared events: per-parameter KL (1-D
    Gaussian approximation), Wasserstein-1, median offset in σ, 90% width
    ratio and histogram Jensen-Shannon divergence."""

    def compare_posteriors(self, samples_a: np.ndarray,
                           samples_b: np.ndarray,
                           param_names=PARAM_NAMES) -> Dict:
        from scipy.stats import wasserstein_distance
        out = {}
        for j, name in enumerate(param_names):
            a, b = samples_a[:, j], samples_b[:, j]
            mu_a, mu_b = a.mean(), b.mean()
            s_a, s_b = max(a.std(), 1e-12), max(b.std(), 1e-12)
            kl = (np.log(s_b / s_a) + (s_a ** 2 + (mu_a - mu_b) ** 2)
                  / (2 * s_b ** 2) - 0.5)
            out[name] = {
                "kl_gauss": float(kl),
                "wasserstein": float(wasserstein_distance(a, b)),
                "median_offset_sigma": float(
                    (np.median(a) - np.median(b)) / s_b),
                "width_ratio": float(
                    (np.quantile(a, 0.95) - np.quantile(a, 0.05))
                    / max(np.quantile(b, 0.95) - np.quantile(b, 0.05),
                          1e-12)),
                "js_divergence": self._js_hist(a, b),
            }
        return out

    @staticmethod
    def _js_hist(a: np.ndarray, b: np.ndarray, bins: int = 64) -> float:
        """Histogram Jensen-Shannon divergence (nats) on the union support,
        which sees multimodality where the Gaussian KL is blind."""
        lo = min(a.min(), b.min())
        hi = max(a.max(), b.max())
        if not np.isfinite(lo) or hi <= lo:
            return 0.0
        pa, _ = np.histogram(a, bins=bins, range=(lo, hi), density=False)
        pb, _ = np.histogram(b, bins=bins, range=(lo, hi), density=False)
        pa = pa / max(pa.sum(), 1)
        pb = pb / max(pb.sum(), 1)
        m = 0.5 * (pa + pb)

        def _kl(p, q):
            mask = p > 0
            return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))
        return 0.5 * _kl(pa, m) + 0.5 * _kl(pb, m)

    @staticmethod
    def summarize(comparison: Dict) -> Dict:
        """A compare_posteriors dict aggregated over its parameters."""
        if not comparison:
            return {}
        offs = [abs(c["median_offset_sigma"]) for c in comparison.values()]
        return {
            "mean_abs_offset_sigma": float(np.mean(offs)),
            "max_abs_offset_sigma": float(np.max(offs)),
            "mean_js": float(np.mean([c["js_divergence"]
                                      for c in comparison.values()])),
            "mean_width_ratio": float(np.mean(
                [c["width_ratio"] for c in comparison.values()])),
            "n_params": len(comparison),
        }
