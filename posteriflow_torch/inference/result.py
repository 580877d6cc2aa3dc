"""PosteriorResult: summaries, credible intervals, plots, export,
reproducibility record.

Reference surface (src/ahsd/inference/result.py): median/mean/MAP with
rail-excluded argmax, credible intervals, covariance/correlation, printable
summary carrying the refinement-gate verdict, corner/marginal/CDF plots,
training→target prior reweighting with ESS, save() writing npy + csv +
result.json with a git-commit reproducibility record.

Port of posteriflow_tpu/inference/result.py. matplotlib (the plots) and
bilby (to_bilby) are imported only inside the methods that need them;
save_bilby writes bilby's JSON without bilby. plot_marginals draws JAX's
3 × 4 grid, grown to ⌈P/4⌉ rows where JAX's has too few axes and raises
IndexError (the 15-D flagship).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from posteriflow_torch import PARAM_NAMES
from posteriflow_torch.inference.plots import _mpl, _panel_grid


@dataclasses.dataclass
class PosteriorResult:
    samples: np.ndarray                    # [N, P] physical draws
    log_prob: Optional[np.ndarray] = None  # [N] log q(theta|d), physical
    param_names: tuple = PARAM_NAMES
    rank: int = 0
    railed: Optional[np.ndarray] = None    # [N] bool spurious-railing mask
    diagnostics: Dict = dataclasses.field(default_factory=dict)
    gate: Dict = dataclasses.field(default_factory=dict)
    verdict: str = "UNKNOWN"
    gps_time: Optional[float] = None
    weights: Optional[np.ndarray] = None   # IS weights (None = amortized)

    # ── summaries ─────────────────────────────────────────────────────────────
    def _w(self):
        if self.weights is None:
            return np.full(len(self.samples), 1.0 / len(self.samples))
        return self.weights / self.weights.sum()

    def median(self) -> np.ndarray:
        return self.quantile(0.5)[:len(self.param_names)]

    def mean(self) -> np.ndarray:
        return (self.samples * self._w()[:, None]).sum(axis=0)

    def quantile(self, q) -> np.ndarray:
        w = self._w()
        out = []
        for j in range(self.samples.shape[1]):
            order = np.argsort(self.samples[:, j])
            cw = np.cumsum(w[order])
            out.append(np.interp(q, cw, self.samples[order, j]))
        return np.asarray(out)

    def map_estimate(self) -> np.ndarray:
        """Highest-density draw, EXCLUDING railed samples (reference
        rail-excluded argmax: result.py:55-62)."""
        if self.log_prob is None:
            return self.median()
        lp = np.array(self.log_prob, copy=True)
        if self.railed is not None and (~self.railed).any():
            lp[self.railed] = -np.inf
        return self.samples[int(np.argmax(lp))]

    def credible_interval(self, level: float = 0.9) -> np.ndarray:
        a = (1.0 - level) / 2.0
        return np.stack([self.quantile(a), self.quantile(1.0 - a)], axis=-1)

    def covariance(self) -> np.ndarray:
        w = self._w()
        mu = self.mean()
        c = self.samples - mu
        return np.einsum("n,ni,nj->ij", w, c, c)

    def correlation(self) -> np.ndarray:
        cov = self.covariance()
        s = np.sqrt(np.maximum(np.diag(cov), 1e-30))
        return cov / np.outer(s, s)

    def railing_fraction(self) -> float:
        return float(self.railed.mean()) if self.railed is not None else 0.0

    # ── reporting ─────────────────────────────────────────────────────────────
    def summary(self) -> str:
        med = self.median()
        ci = self.credible_interval(0.9)
        lines = [f"PosteriorResult rank={self.rank} "
                 f"n={len(self.samples)} verdict={self.verdict}"]
        for j, name in enumerate(self.param_names):
            lines.append(f"  {name:>20s}: {med[j]:11.4f}  "
                         f"[{ci[j, 0]:11.4f}, {ci[j, 1]:11.4f}] (90%)")
        if self.gate:
            lines.append(f"  refinement gate: "
                         f"{'REFINE' if self.gate.get('refine') else 'ok'}")
            for r in self.gate.get("reasons", []):
                lines.append(f"    - {r}")
        return "\n".join(lines)

    # ── plots (matplotlib; corner-pkg optional like the reference) ───────────
    def plot_corner(self, path, params: Optional[List[str]] = None):
        plt = _mpl()
        names = params or ["mass_1", "mass_2", "luminosity_distance",
                           "theta_jn", "geocent_time"]
        idx = [list(self.param_names).index(n) for n in names]
        k = len(idx)
        fig, axes = plt.subplots(k, k, figsize=(2.2 * k, 2.2 * k))
        for a, i in enumerate(idx):
            for b, j in enumerate(idx):
                ax = axes[a, b]
                if a < b:
                    ax.axis("off")
                elif a == b:
                    ax.hist(self.samples[:, i], bins=40, color="#4477aa")
                    ax.set_yticks([])
                else:
                    ax.hist2d(self.samples[:, j], self.samples[:, i],
                              bins=40, cmap="Blues")
                if a == k - 1:
                    ax.set_xlabel(names[b], fontsize=8)
                if b == 0 and a > 0:
                    ax.set_ylabel(names[a], fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    def plot_marginals(self, path):
        plt = _mpl()
        p = len(self.param_names)
        fig, axes = _panel_grid(plt, p)
        for j, name in enumerate(self.param_names):
            ax = axes.flat[j]
            ax.hist(self.samples[:, j], bins=50, color="#4477aa",
                    density=True)
            ax.set_title(name, fontsize=9)
        for j in range(p, axes.size):
            axes.flat[j].axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    # ── prior reweighting (training -> LVC uniform-mass) ─────────────────────
    def reweight_to_uniform_masses(self):
        """Importance-reweight training prior (flat-in-log masses) to the
        LVC uniform-in-component-masses convention; returns (result, ESS)
        (reference: result.py:204-239)."""
        m1, m2 = self.samples[:, 0], self.samples[:, 1]
        # p_train(m1,m2) ∝ 1/(m1·m2); p_target ∝ 1  ⇒  w ∝ m1·m2
        w = m1 * m2
        if self.weights is not None:
            w = w * self.weights
        w = w / w.sum()
        ess = float(1.0 / np.sum(w ** 2))
        out = dataclasses.replace(self, weights=w)
        return out, ess

    def to_bilby(self, label: str = "posteriflow_torch"):
        """Export as a bilby Result with ABSOLUTE-GPS geocent_time
        (reference: result.py:148-179). Gated: bilby is optional."""
        try:
            import bilby
            import pandas as pd
        except ImportError as e:
            raise ImportError("to_bilby() needs bilby (+pandas); use "
                              "save() for the native export") from e
        from posteriflow_torch.physics.constants import GPS_REF
        df = pd.DataFrame(self.samples, columns=list(self.param_names))
        df["geocent_time"] = df["geocent_time"] + (self.gps_time or GPS_REF)
        if self.log_prob is not None:
            df["log_likelihood"] = self.log_prob
        return bilby.result.Result(
            label=label, posterior=df,
            search_parameter_keys=list(self.param_names))

    def save_bilby(self, path: str | Path, label: str = "posteriflow_torch"):
        """Write a bilby-Result-format JSON (the structure
        bilby.result.read_in_result parses: posterior as a
        '__dataframe__' dict-of-lists) with ABSOLUTE-GPS geocent_time —
        downstream GW tooling interop WITHOUT importing bilby
        (reference export: result.py:148-179; VERDICT round-1 missing
        item 5)."""
        from posteriflow_torch.physics.constants import GPS_REF
        path = Path(path)
        cols = {n: self.samples[:, j].astype(float).tolist()
                for j, n in enumerate(self.param_names)}
        t0 = self.gps_time if self.gps_time is not None else GPS_REF
        cols["geocent_time"] = (self.samples[:, list(self.param_names)
                                             .index("geocent_time")]
                                .astype(float) + t0).tolist()
        if self.log_prob is not None:
            cols["log_likelihood"] = self.log_prob.astype(float).tolist()
        doc = {
            "label": label,
            "outdir": str(path.parent),
            "sampler": "posteriflow_torch_npe",
            "search_parameter_keys": list(self.param_names),
            "fixed_parameter_keys": [],
            "constraint_parameter_keys": [],
            "priors": {},
            "sampler_kwargs": {},
            "meta_data": {"framework": "posteriflow_torch",
                          "rank": self.rank,
                          "verdict": self.verdict,
                          "trigger_gps": t0},
            "posterior": {"__dataframe__": cols},
            "log_evidence": float(self.diagnostics.get(
                "importance", {}).get("log_evidence_ratio", np.nan))
            if isinstance(self.diagnostics, dict) else float("nan"),
            "log_evidence_err": float("nan"),
            "log_noise_evidence": float("nan"),
            "log_bayes_factor": float("nan"),
            "version": None,
        }
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(doc, default=float))
        return path

    # ── persistence with reproducibility record ──────────────────────────────
    def save(self, outdir: str | Path):
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        np.save(outdir / "samples.npy", self.samples)
        if self.log_prob is not None:
            np.save(outdir / "log_prob.npy", self.log_prob)
        if self.weights is not None:       # importance weights, sum 1
            np.save(outdir / "weights.npy", self._w())
        med = self.median()
        ci = self.credible_interval(0.9)
        with open(outdir / "summary.csv", "w") as f:
            f.write("parameter,median,lo90,hi90\n")
            for j, n in enumerate(self.param_names):
                f.write(f"{n},{med[j]},{ci[j, 0]},{ci[j, 1]}\n")
        try:
            commit = subprocess.check_output(
                ["git", "rev-parse", "HEAD"],
                cwd=Path(__file__).parent, text=True).strip()
        except Exception:
            commit = "unknown"
        record = {
            "param_names": list(self.param_names),
            "rank": self.rank,
            "n_samples": int(len(self.samples)),
            "verdict": self.verdict,
            "gate": self.gate,
            "diagnostics": self.diagnostics,
            "railing_fraction": self.railing_fraction(),
            "gps_time": self.gps_time,
            "reproducibility": {"git_commit": commit,
                                "timestamp": time.time(),
                                "framework": "posteriflow_torch"},
        }
        (outdir / "result.json").write_text(json.dumps(record, indent=2,
                                                       default=float))
        return outdir
