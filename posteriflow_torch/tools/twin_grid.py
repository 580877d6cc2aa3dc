"""Twin-injection amortization-bias grid over (Mc, q, theta_jn) at fixed
SNR — the measured bias map the refinement gate consumes.

The port's twin of scripts/twin_grid.py. For each point of the
--mc-grid × --q-grid (Mc, q) grid (a 15-D checkpoint draws each point's
tilts from numpy's default_rng(7), as JAX does), the distance is rescaled
so that the design-ASD network SNR is --target-snr, the point is injected
twice with different noise and inferred, and the median-recovery biases
are recorded; `q_attractor_band` spans the q values whose mean |q bias|
exceeds 0.05. Everything runs on --device (default cuda).

Usage:
  python -m posteriflow_torch.tools.twin_grid --ckpt DIR --out analysis/twin_grid.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--target-snr", type=float, default=24.0)
    ap.add_argument("--n-samples", type=int, default=400)
    ap.add_argument("--mc-grid", type=int, default=4)
    ap.add_argument("--q-grid", type=int, default=4)
    ap.add_argument("--out", default="analysis/twin_grid.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import torch

    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.physics.simulator import (design_asd,
                                                     signal_white_fd)

    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    names = tuple(engine.cfg.param_names)
    asd = design_asd(engine.device)

    def snr_of(p):
        theta = torch.tensor([[p.get(k, 0.0) for k in names]],
                             dtype=torch.float32, device=engine.device)
        with torch.no_grad():
            return float(torch.sqrt(torch.sum(
                torch.abs(signal_white_fd(theta, asd)) ** 2)))

    rng = np.random.default_rng(7)
    grid = []
    for mc in np.geomspace(12.0, 45.0, args.mc_grid):
        for q in np.linspace(0.35, 0.95, args.q_grid):
            m1 = mc * (1 + q) ** 0.2 / q ** 0.6
            m2 = q * m1
            p = dict(mass_1=float(m1), mass_2=float(m2),
                     luminosity_distance=500.0, ra=1.3, dec=-0.2,
                     theta_jn=0.8, psi=0.5, phase=1.0, geocent_time=0.1,
                     a1=0.0, a2=0.0)
            if len(names) >= 15:
                # a 15-D flagship is gated on PRECESSING events — probe
                # the bias with seeded isotropic tilts, moderate spins
                p.update(a1=0.4, a2=0.2,
                         tilt_1=float(np.arccos(rng.uniform(-1, 1))),
                         tilt_2=float(np.arccos(rng.uniform(-1, 1))),
                         phi_12=float(rng.uniform(0, 2 * np.pi)),
                         phi_jl=float(rng.uniform(0, 2 * np.pi)))
            # rescale distance to the target SNR (amplitude ∝ 1/d)
            rho = snr_of(p)
            p["luminosity_distance"] = float(np.clip(
                p["luminosity_distance"] * rho / args.target_snr,
                45.0, 2100.0))

            biases = []
            for twin in range(2):
                prep = prepare_simulated([p], seed=1000 + twin,
                                         psd_bands=engine.cfg.psd_bands,
                                         param_names=names,
                                         device=engine.device)
                res = infer(engine, data=prep, n_samples=args.n_samples,
                            seed=twin)
                med = res.median()
                mc_r = (med[0] * med[1]) ** 0.6 / (med[0] + med[1]) ** 0.2
                q_r = med[1] / max(med[0], 1e-6)
                biases.append({"mc_bias_frac": float((mc_r - mc) / mc),
                               "q_bias": float(q_r - q)})
            grid.append({"mc": float(mc), "q": float(q),
                         "distance": p["luminosity_distance"],
                         "twins": biases,
                         "mc_bias_frac_mean": float(np.mean(
                             [b["mc_bias_frac"] for b in biases])),
                         "q_bias_mean": float(np.mean(
                             [b["q_bias"] for b in biases]))})
            log.info("Mc=%.1f q=%.2f -> mc bias %+.3f, q bias %+.3f",
                     mc, q, grid[-1]["mc_bias_frac_mean"],
                     grid[-1]["q_bias_mean"])

    # locate the q-attractor: band of q with systematic |q bias| > 0.05
    qs = sorted({g["q"] for g in grid})
    band = [q for q in qs if np.mean([abs(g["q_bias_mean"]) for g in grid
                                      if g["q"] == q]) > 0.05]
    from posteriflow_torch.utils.provenance import artifact_meta
    report = {"grid": grid,
              "q_attractor_band": [min(band), max(band)] if band else None,
              "target_snr": args.target_snr,
              "_meta": artifact_meta(args.ckpt)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    log.info("-> %s (attractor band: %s)", out, report["q_attractor_band"])
    return report


if __name__ == "__main__":
    main()
