"""Refinement gate: should this posterior be refined with exact methods?

Reference semantics (src/ahsd/inference/gating.py): five indicators —
confidence verdict, OOD percentile, amortization-bias map region (the twin
grid's q-attractor band), chirp-mass posterior width, railing — each
scored none/moderate/strong; any strong or ≥2 moderate ⇒ refine, with
auditable reasons and parameter-level distrust for masses inside the
q-attractor band.

A numpy copy of posteriflow_tpu/inference/gating.py.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

Q_ATTRACTOR = (0.30, 0.80)      # mass-ratio band with measured NPE bias
                                # (reference: analysis/twin_grid_v3.json
                                # consumed at gating.py:36-67)

_BIAS_MAP_CACHE: Optional[dict] = None
_BIAS_MAP_MISSING = object()


def load_bias_map(path: Optional[str | Path] = None) -> Optional[dict]:
    """The measured twin-injection amortization-bias grid
    (analysis/twin_grid.json, regenerated per flagship by
    scripts/twin_grid.py). Cached; returns None when absent."""
    global _BIAS_MAP_CACHE
    if path is not None:
        p = Path(path)
        return json.loads(p.read_text()) if p.exists() else None
    if _BIAS_MAP_CACHE is None:
        p = Path(__file__).resolve().parents[2] / "analysis" / \
            "twin_grid.json"
        _BIAS_MAP_CACHE = (json.loads(p.read_text()) if p.exists()
                           else _BIAS_MAP_MISSING)
    return None if _BIAS_MAP_CACHE is _BIAS_MAP_MISSING else _BIAS_MAP_CACHE


def bias_region(mc: float, q: float, bias_map: Optional[dict]) -> dict:
    """Posterior-median lookup in the measured bias grid (reference
    gating.py:36-67 semantics, this framework's twin-grid schema): the
    nearest cell in (log Mc, q) and its measured chirp-mass/mass-ratio
    biases; severe when the cell's measured bias is large."""
    out = {"q_in_attractor": bool(Q_ATTRACTOR[0] < q < Q_ATTRACTOR[1]
                                  and mc > 8.0)}
    grid = (bias_map or {}).get("grid") if bias_map else None
    if grid:
        cell = min(grid, key=lambda r: (np.log(max(mc, 1.0) / r["mc"]) ** 2
                                        + 4.0 * (q - r["q"]) ** 2))
        mcb = abs(float(cell.get("mc_bias_frac_mean", 0.0)))
        qb = abs(float(cell.get("q_bias_mean", 0.0)))
        out.update({"cell": {"mc": cell["mc"], "q": round(cell["q"], 3)},
                    "mc_bias_frac": round(float(
                        cell.get("mc_bias_frac_mean", 0.0)), 3),
                    "q_bias": round(float(cell.get("q_bias_mean", 0.0)), 3),
                    "severe_mass_bias": bool(mcb > 0.30 or qb > 0.40)})
    else:
        out.update({"cell": None, "severe_mass_bias": False})
    return out


def refinement_gate(verdict: str, ood_percentile: float,
                    railing_frac: float, samples: np.ndarray,
                    bias_map: Optional[dict] = None) -> dict:
    """samples [N, P] physical posterior draws (PARAM_NAMES order).

    Returns {refine: bool, reasons: [str], distrust: [param names]}."""
    reasons, moderate, strong = [], 0, 0

    if verdict == "LOW":
        strong += 1
        reasons.append("confidence verdict LOW")
    elif verdict == "MEDIUM":
        moderate += 1
        reasons.append("confidence verdict MEDIUM")

    if ood_percentile >= 100.0:
        strong += 1
        reasons.append(f"context OOD beyond validation support "
                       f"({ood_percentile:.1f}%)")
    elif ood_percentile >= 99.0:
        moderate += 1
        reasons.append(f"context OOD percentile {ood_percentile:.1f}%")

    if railing_frac >= 0.20:
        strong += 1
        reasons.append(f"railing fraction {railing_frac:.2f}")
    elif railing_frac >= 0.05:
        moderate += 1
        reasons.append(f"railing fraction {railing_frac:.2f}")

    m1, m2 = samples[:, 0], samples[:, 1]
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    q_med = float(np.median(m2 / np.maximum(m1, 1e-6)))
    mc_med0 = float(np.median(mc))
    distrust = []
    region = bias_region(mc_med0, q_med, bias_map)
    if region["q_in_attractor"]:
        if region.get("severe_mass_bias"):
            strong += 1
            distrust = ["mass_1", "mass_2"]
            cell = region.get("cell")
            reasons.append(
                f"median (Mc={mc_med0:.1f}, q={q_med:.2f}) in measured "
                f"bias cell {cell}: Mc bias {region.get('mc_bias_frac')}, "
                f"q bias {region.get('q_bias')}")
        else:
            moderate += 1
            distrust = ["mass_1", "mass_2"]
            reasons.append(f"median q={q_med:.2f} in measured bias "
                           f"attractor band {Q_ATTRACTOR}")

    # chirp-mass posterior width fraction (reference thresholds 0.6/1.0)
    mc_med = float(np.median(mc))
    width = float(np.quantile(mc, 0.95) - np.quantile(mc, 0.05))
    frac = width / max(mc_med, 1e-6)
    if frac >= 1.0:
        strong += 1
        reasons.append(f"chirp-mass 90% width {frac:.2f}x median")
    elif frac >= 0.6:
        moderate += 1
        reasons.append(f"chirp-mass 90% width {frac:.2f}x median")

    refine = strong >= 1 or moderate >= 2
    return {"refine": bool(refine), "reasons": reasons,
            "distrust": distrust, "n_strong": strong, "n_moderate": moderate}
