"""Evaluation metrics: bias, performance, recovery, method comparison.

Port of posteriflow_tpu/evaluation/metrics.py: parameter-wise bias with
significance, timing/accuracy grades and scaling efficiency, hard and soft
(multi-criteria) signal matching with precision/recall/F1 and failure
analysis, per-parameter posterior comparison, and the multi-method ranking
with paired significance tests. Numpy and scipy on the host: evaluation is
offline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from posteriflow_torch import PARAM_NAMES


class BiasMetrics:
    """Parameter-wise bias of posterior summaries against truth."""

    def __init__(self, param_names: Sequence[str] = PARAM_NAMES):
        self.param_names = tuple(param_names)

    def compute(self, estimates: np.ndarray, truths: np.ndarray,
                stds: Optional[np.ndarray] = None) -> Dict:
        """estimates/truths [N, P]; stds [N, P] posterior widths (for
        normalized bias). Returns per-parameter bias stats + significance."""
        est = np.asarray(estimates, dtype=np.float64)
        tru = np.asarray(truths, dtype=np.float64)
        err = est - tru
        out = {}
        for j, name in enumerate(self.param_names):
            e = err[:, j]
            n = len(e)
            mean_bias = float(e.mean())
            sem = float(e.std(ddof=1) / np.sqrt(max(n, 2)))
            z = mean_bias / max(sem, 1e-30)
            rec = {
                "mean_bias": mean_bias,
                "median_bias": float(np.median(e)),
                "std": float(e.std()),
                "mae": float(np.abs(e).mean()),
                "frac_err_median": float(np.median(
                    np.abs(e) / np.maximum(np.abs(tru[:, j]), 1e-9))),
                "bias_significance_z": float(z),
                "significant": bool(abs(z) > 3.0),
                "skewness": self._skewness(e),
                "kurtosis_excess": self._kurtosis(e),
            }
            if stds is not None:
                rec["normalized_bias"] = float(
                    np.mean(e / np.maximum(stds[:, j], 1e-12)))
            out[name] = rec
        return out

    @staticmethod
    def _skewness(e: np.ndarray) -> float:
        s = e.std()
        return float(np.mean(((e - e.mean()) / max(s, 1e-30)) ** 3))

    @staticmethod
    def _kurtosis(e: np.ndarray) -> float:
        s = e.std()
        return float(np.mean(((e - e.mean()) / max(s, 1e-30)) ** 4) - 3.0)

    @staticmethod
    def overall(param_biases: Dict) -> Dict:
        """Cross-parameter roll-up (reference BiasMetrics
        _compute_overall_bias_metrics, metrics.py:265): worst offenders +
        the count of statistically significant biases."""
        if not param_biases:
            return {}
        sig = [k for k, v in param_biases.items() if v["significant"]]
        z = {k: abs(v["bias_significance_z"]) for k, v in
             param_biases.items()}
        worst = max(z, key=z.get)
        return {"n_significant": len(sig), "significant_params": sig,
                "worst_param": worst, "worst_z": z[worst],
                "mean_abs_z": float(np.mean(list(z.values()))),
                "mean_frac_err_median": float(np.mean(
                    [v["frac_err_median"] for v in param_biases.values()]))}


class PerformanceMetrics:
    """Timing/throughput/accuracy aggregation with letter grades
    (reference: metrics.py:352+)."""

    GRADES = ((0.9, "A"), (0.75, "B"), (0.6, "C"), (0.4, "D"), (0.0, "F"))

    def __init__(self):
        self.records: List[Dict] = []

    def record(self, wall_time_s: float, n_samples: int,
               accuracy_score: float = 1.0, **extra):
        self.records.append({"wall_time_s": wall_time_s,
                             "n_samples": n_samples,
                             "accuracy_score": accuracy_score, **extra})

    def summary(self) -> Dict:
        if not self.records:
            return {}
        t = np.array([r["wall_time_s"] for r in self.records])
        n = np.array([r["n_samples"] for r in self.records])
        acc = np.array([r["accuracy_score"] for r in self.records])
        thr = n.sum() / max(t.sum(), 1e-12)
        score = float(np.clip(acc.mean(), 0, 1))
        grade = next(g for thresh, g in self.GRADES if score >= thresh)
        return {"mean_wall_time_s": float(t.mean()),
                "median_wall_time_s": float(np.median(t)),
                "throughput_per_s": float(thr),
                "accuracy_score": score, "grade": grade,
                "n_runs": len(self.records)}

    @classmethod
    def scalability(cls, sizes: Sequence[float],
                    throughputs: Sequence[float]) -> Dict:
        """Scaling-efficiency grade from a (problem size, throughput)
        curve (reference PerformanceMetrics scalability grading,
        metrics.py:352+): efficiency = measured throughput at the largest
        size / throughput at the smallest size (ideal strong scaling for
        a per-item rate is a FLAT curve; falling = super-linear cost)."""
        s = np.asarray(sizes, dtype=np.float64)
        thr = np.asarray(throughputs, dtype=np.float64)
        order = np.argsort(s)
        s, thr = s[order], thr[order]
        eff = float(thr[-1] / max(thr[0], 1e-12))
        score = float(np.clip(eff, 0.0, 1.0))
        grade = next(g for thresh, g in cls.GRADES if score >= thresh)
        return {"sizes": s.tolist(), "throughputs": thr.tolist(),
                "scaling_efficiency": eff, "grade": grade,
                "peak_throughput": float(thr.max()),
                "best_size": float(s[int(np.argmax(thr))])}


class RecoveryMetrics:
    """Multi-criteria matching of recovered signals to injections ->
    precision/recall/F1 (reference RecoveryMetrics)."""

    def __init__(self, mc_tol: float = 0.2, time_tol: float = 0.1):
        self.mc_tol = mc_tol
        self.time_tol = time_tol

    @staticmethod
    def _mc(p):
        return (p[0] * p[1]) ** 0.6 / (p[0] + p[1]) ** 0.2

    def match(self, recovered: np.ndarray, injected: np.ndarray) -> Dict:
        """recovered [R, P] median params; injected [I, P] truth.
        Greedy best-match within chirp-mass + merger-time tolerance."""
        rec = np.atleast_2d(recovered)
        inj = np.atleast_2d(injected)
        used = set()
        matches = []
        for i, t in enumerate(inj):
            best, best_d = None, np.inf
            for r, e in enumerate(rec):
                if r in used:
                    continue
                mc_t, mc_r = self._mc(t), self._mc(e)
                d_mc = abs(mc_r - mc_t) / max(mc_t, 1e-9)
                d_t = abs(e[8] - t[8])
                if d_mc < self.mc_tol and d_t < self.time_tol:
                    d = d_mc + d_t
                    if d < best_d:
                        best, best_d = r, d
            if best is not None:
                used.add(best)
                matches.append((best, i))
        tp = len(matches)
        fp = len(rec) - tp
        fn = len(inj) - tp
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return {"matches": matches, "n_recovered": len(rec),
                "n_injected": len(inj), "precision": precision,
                "recall": recall, "f1": f1}

    # Soft multi-criteria matching (reference RecoveryMetrics
    # _compute_signal_match_score, metrics.py:751-949): weighted Gaussian
    # component scores — mass 0.4, merger time 0.3, sky 0.2, distance 0.1.
    W_MASS, W_TIME, W_SKY, W_DIST = 0.4, 0.3, 0.2, 0.1

    @classmethod
    def match_score(cls, est: np.ndarray, truth: np.ndarray,
                    est_std: Optional[np.ndarray] = None) -> Dict:
        """Soft [0,1] match quality between one recovered parameter vector
        and one injection (param order = PARAM_NAMES). est_std: posterior
        widths for σ-normalized mass errors (reference uses 10%/5% floors
        when absent, metrics.py:797-839)."""
        est = np.asarray(est, np.float64)
        tru = np.asarray(truth, np.float64)
        sd = (np.asarray(est_std, np.float64) if est_std is not None
              else np.abs(est) * 0.1)
        # masses: Gaussian in std-normalized error (floor 5% of truth)
        z1 = abs(est[0] - tru[0]) / max(sd[0], 0.05 * tru[0])
        z2 = abs(est[1] - tru[1]) / max(sd[1], 0.05 * tru[1])
        s_mass = float(np.exp(-0.5 * z1 ** 2) * np.exp(-0.5 * z2 ** 2))
        # merger time: threshold max(3σ_t, 10 ms)
        sd_t = sd[8] if est_std is not None else 0.01
        thr_t = max(3.0 * sd_t, 0.010)
        s_time = float(np.exp(-((est[8] - tru[8]) / thr_t) ** 2))
        # sky: great-circle separation, 0.5 rad scale
        sep = cls._angular_separation(est[3], est[4], tru[3], tru[4])
        s_sky = float(np.exp(-(sep / 0.5) ** 2))
        # distance: log-space, 0.2 dex floor
        sd_ld = (sd[2] / max(est[2], 1e-9)) if est_std is not None else 0.2
        zd = abs(np.log(max(est[2], 1e-9) / max(tru[2], 1e-9))) \
            / max(sd_ld, 0.2)
        s_dist = float(np.exp(-0.5 * zd ** 2))
        total = (cls.W_MASS * s_mass + cls.W_TIME * s_time
                 + cls.W_SKY * s_sky + cls.W_DIST * s_dist)
        return {"score": float(total), "mass": s_mass, "time": s_time,
                "sky": s_sky, "distance": s_dist}

    @staticmethod
    def _angular_separation(ra1, dec1, ra2, dec2) -> float:
        """Great-circle separation in radians (reference
        _compute_sky_match_score, metrics.py:869)."""
        c = (np.sin(dec1) * np.sin(dec2)
             + np.cos(dec1) * np.cos(dec2) * np.cos(ra1 - ra2))
        return float(np.arccos(np.clip(c, -1.0, 1.0)))

    def match_soft(self, recovered: np.ndarray, injected: np.ndarray,
                   rec_stds: Optional[np.ndarray] = None,
                   min_score: float = 0.3) -> Dict:
        """Greedy soft matching: every (recovered, injected) pair is
        scored with match_score; pairs are claimed best-score-first above
        min_score. Returns precision/recall/F1 plus per-match quality —
        the reference's match + _analyze_recovery_quality combined
        (metrics.py:676-1055)."""
        rec = np.atleast_2d(recovered)
        inj = np.atleast_2d(injected)
        pairs = []
        for r in range(len(rec)):
            sd = rec_stds[r] if rec_stds is not None else None
            for i in range(len(inj)):
                s = self.match_score(rec[r], inj[i], sd)
                if s["score"] >= min_score:
                    pairs.append((s["score"], r, i, s))
        pairs.sort(key=lambda p: -p[0])
        used_r, used_i, matches = set(), set(), []
        for score, r, i, s in pairs:
            if r in used_r or i in used_i:
                continue
            used_r.add(r)
            used_i.add(i)
            matches.append({"recovered": r, "injected": i, **s})
        tp = len(matches)
        precision = tp / max(len(rec), 1)
        recall = tp / max(len(inj), 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return {"matches": matches, "precision": precision,
                "recall": recall, "f1": f1,
                "mean_match_score": float(np.mean(
                    [m["score"] for m in matches])) if matches else 0.0,
                "n_recovered": len(rec), "n_injected": len(inj)}

    @staticmethod
    def failure_analysis(soft_result: Dict, injected: np.ndarray,
                         loudness: Optional[np.ndarray] = None) -> Dict:
        """Which injections were missed, and are misses loudness-biased?
        (reference _analyze_recovery_failures, metrics.py:1056-1150).
        loudness: per-injection proxy (e.g. network SNR); defaults to
        Mc^(5/6)/d_L."""
        inj = np.atleast_2d(injected)
        if loudness is None:
            mc = (inj[:, 0] * inj[:, 1]) ** 0.6 / (inj[:, 0]
                                                   + inj[:, 1]) ** 0.2
            loudness = mc ** (5.0 / 6.0) / np.maximum(inj[:, 2], 1e-9)
        loudness = np.asarray(loudness, np.float64)
        hit = np.zeros(len(inj), dtype=bool)
        for m in soft_result["matches"]:
            hit[m["injected"]] = True
        missed = np.where(~hit)[0]
        out = {"n_missed": int(missed.size),
               "missed_indices": missed.tolist()}
        if missed.size and hit.any():
            out["missed_mean_loudness"] = float(loudness[missed].mean())
            out["matched_mean_loudness"] = float(loudness[hit].mean())
            out["misses_are_quieter"] = bool(
                out["missed_mean_loudness"] < out["matched_mean_loudness"])
        # weakest component among successful matches: where recovery
        # quality is lost even when signals ARE found
        if soft_result["matches"]:
            comp = {k: float(np.mean([m[k] for m in
                                      soft_result["matches"]]))
                    for k in ("mass", "time", "sky", "distance")}
            out["component_means"] = comp
            out["weakest_component"] = min(comp, key=comp.get)
        return out


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

    # ── multi-method comparison (reference ComparisonMetrics
    #    compare_methods / _compute_method_ranking /
    #    _test_statistical_significance, metrics.py:1157-1465) ──────────

    def compare_methods(self, method_results: Dict[str, Dict]) -> Dict:
        """method_results: name → {"accuracy": [per-event score],
        "wall_time_s": [per-event seconds], optional "quality": [...]}.
        Returns pairwise winners, a composite ranking, and paired
        significance tests on shared events."""
        names = list(method_results)
        pairwise = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                pairwise[f"{a}_vs_{b}"] = self._compare_two(
                    a, method_results[a], b, method_results[b])
        ranking = self._rank_methods(method_results)
        return {"pairwise": pairwise, "ranking": ranking,
                "significance": self._significance(method_results),
                "n_methods": len(names)}

    @staticmethod
    def _compare_two(name_a: str, res_a: Dict, name_b: str,
                     res_b: Dict) -> Dict:
        acc_a = float(np.mean(res_a.get("accuracy", [0.0])))
        acc_b = float(np.mean(res_b.get("accuracy", [0.0])))
        t_a = float(np.sum(res_a.get("wall_time_s", [np.inf])))
        t_b = float(np.sum(res_b.get("wall_time_s", [np.inf])))
        acc_winner = (name_a if acc_a > acc_b
                      else name_b if acc_b > acc_a else "tie")
        t_winner = (name_a if t_a < t_b
                    else name_b if t_b < t_a else "tie")
        wins = {name_a: 0, name_b: 0, "tie": 0}
        wins[acc_winner] += 1
        wins[t_winner] += 1
        overall = (name_a if wins[name_a] > wins[name_b]
                   else name_b if wins[name_b] > wins[name_a] else "tie")
        return {"accuracy": {name_a: acc_a, name_b: acc_b,
                             "winner": acc_winner},
                "timing": {name_a: t_a, name_b: t_b, "winner": t_winner,
                           "speedup": float(max(t_a, t_b)
                                            / max(min(t_a, t_b), 1e-9))},
                "winner": overall, "win_counts": wins}

    @staticmethod
    def _rank_methods(method_results: Dict[str, Dict]) -> List[Dict]:
        """Composite score = mean accuracy − 0.1·log10(total seconds):
        accuracy dominates, an order of magnitude of wall time costs one
        decimal of accuracy (reference weights accuracy over timing in
        _compute_method_ranking)."""
        rows = []
        for name, res in method_results.items():
            acc = float(np.mean(res.get("accuracy", [0.0])))
            t = float(np.sum(res.get("wall_time_s", [1.0])))
            rows.append({"method": name, "accuracy": acc,
                         "total_wall_s": t,
                         "composite": acc - 0.1 * np.log10(max(t, 1e-9))})
        rows.sort(key=lambda r: -r["composite"])
        for k, r in enumerate(rows):
            r["rank"] = k + 1
        return rows

    @staticmethod
    def _significance(method_results: Dict[str, Dict]) -> Dict:
        """Paired Wilcoxon signed-rank on per-event accuracy for every
        method pair sharing ≥3 events (the reference uses a two-sample
        t-test, metrics.py:1430-1440; paired is strictly more appropriate
        on shared events and degrades to the same conclusion)."""
        from scipy.stats import ttest_rel, wilcoxon
        names = list(method_results)
        out = {}
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                xa = np.asarray(method_results[a].get("accuracy", []),
                                np.float64)
                xb = np.asarray(method_results[b].get("accuracy", []),
                                np.float64)
                if len(xa) != len(xb) or len(xa) < 3:
                    continue
                d = xa - xb
                if np.allclose(d, 0):
                    out[f"{a}_vs_{b}"] = {"p_value": 1.0,
                                          "significant": False,
                                          "test": "degenerate"}
                    continue
                try:
                    stat, p = wilcoxon(xa, xb)
                    test = "wilcoxon"
                except ValueError:
                    stat, p = ttest_rel(xa, xb)
                    test = "ttest_rel"
                out[f"{a}_vs_{b}"] = {"statistic": float(stat),
                                      "p_value": float(p),
                                      "significant": bool(p < 0.05),
                                      "test": test,
                                      "mean_diff": float(d.mean())}
        return out
