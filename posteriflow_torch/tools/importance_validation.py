"""Importance-sampling validation battery -> analysis/importance_validation.json.

The port's twin of scripts/importance_validation.py. For reference-like
injections (CASES, or the --cases named), run amortized inference with
the checkpoint, importance-correct against the phase/time-marginalized
Whittle likelihood, and record ESS / efficiency / evidence / ladder
diagnostics per case; --cross-check also runs the flow-independent
prior-anchored SMC (run_smc_prior) on the same likelihood and records the
logZ gap between the two estimators. An untimed warm-up pass (unless
--no-warmup) keeps one-time set-up (kernel builds, FFT plans) out of the
cases' wall_s. Everything runs on --device (default cuda).

Usage: python -m posteriflow_torch.tools.importance_validation --ckpt DIR \\
           [--n-samples 4096] [--cases gw150914_like ...] \\
           [--out analysis/importance_validation.json]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

CASES = {
    "gw150914_like": dict(mass_1=36.0, mass_2=29.0,
                          luminosity_distance=400.0),
    "gw170814_like": dict(mass_1=30.6, mass_2=25.2,
                          luminosity_distance=540.0),
    "gw170608_like": dict(mass_1=11.0, mass_2=7.6,
                          luminosity_distance=320.0),
    "weak_distant": dict(mass_1=35.0, mass_2=28.0,
                         luminosity_distance=1500.0),
}


def _mc(theta) -> float:
    return float((theta[0] * theta[1]) ** 0.6
                 / (theta[0] + theta[1]) ** 0.2)


def _weighted_median(res, seed: int) -> np.ndarray:
    """Median of 2000 draws resampled by the normalized weights."""
    pick = np.random.default_rng(seed).choice(
        len(res.samples), 2000, p=res.weights / res.weights.sum())
    return np.median(res.samples[pick], axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-samples", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cases", nargs="+", choices=list(CASES),
                    default=list(CASES),
                    help="the cases to run (default: all, in CASES order)")
    ap.add_argument("--cross-check", action="store_true",
                    help="also run the flow-independent prior-anchored "
                         "SMC sampler per case and record the logZ gap "
                         "between the two estimators (exactness evidence)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed warm-up pass; per-case wall_s "
                         "then includes one-time set-up")
    ap.add_argument("--out", default="analysis/importance_validation.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    from posteriflow_torch.inference import importance as imp
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.prior import PriorConfig
    from posteriflow_torch.utils.provenance import artifact_meta

    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    names = tuple(engine.cfg.param_names)
    # the flow-independent cross-check must integrate the SAME parameter
    # space as the flow-IS evidence (15-D prior for a 15-D checkpoint) or
    # the logZ gap compares different model classes
    prior_cfg = PriorConfig(precessing=len(names) >= 15)

    def correct(prep, seed):
        res = infer(engine, data=prep, n_samples=args.n_samples, seed=seed)
        ctx = engine.encode(prep.strain[None], prep.asd_bands[None])
        log_l = imp.make_marginalized_log_likelihood(prep.strain,
                                                     device=engine.device)
        is_res = imp.importance_correct(engine, ctx[0], 0, res.samples,
                                        res.log_prob, res.railed, log_l,
                                        marginalized=True, seed=seed)
        return is_res, log_l

    out = {}
    if not args.no_warmup:
        t0 = time.time()
        p0 = next(iter(CASES.values()))
        full0 = {"ra": 1.0, "dec": 0.3, "theta_jn": 0.6, "psi": 0.4,
                 "phase": 1.0, "geocent_time": 0.1, "a1": 0.1, "a2": 0.05,
                 **p0}
        prep0 = prepare_simulated([full0], seed=args.seed,
                                  param_names=names, device=engine.device)
        _, log_l0 = correct(prep0, args.seed)
        if args.cross_check:
            imp.run_smc_prior(log_l0, seed=args.seed + 99, marginalized=True,
                              prior_cfg=prior_cfg)
        out["_meta"] = artifact_meta(args.ckpt,
                                     warmup_s=round(time.time() - t0, 1))
        log.info("warm-up: %.1f s", out["_meta"]["warmup_s"])

    for i, (case, p) in enumerate(CASES.items()):
        if case not in args.cases:
            continue
        full = {"ra": 1.0 + i, "dec": 0.3 - 0.15 * i, "theta_jn": 0.6,
                "psi": 0.4, "phase": 1.0, "geocent_time": 0.1,
                "a1": 0.1, "a2": 0.05, **p}
        t0 = time.time()
        prep = prepare_simulated([full], seed=args.seed + i,
                                 param_names=names, device=engine.device)
        is_res, log_l = correct(prep, args.seed + i)
        out[case] = {
            "truth_mc": round(_mc([p["mass_1"], p["mass_2"]]), 2),
            "n": int(len(is_res.samples)),
            "ess": round(float(is_res.ess), 1),
            "efficiency": round(float(is_res.efficiency), 4),
            "n_stages": int(is_res.n_stages),
            "converged": bool(is_res.converged),
            "beta_ladder": is_res.beta_ladder,
            "mcmc_acceptance": is_res.mcmc_acceptance,
            "log_evidence_ratio": round(float(is_res.log_evidence_ratio),
                                        2),
            "corrected_mc_median": round(
                _mc(_weighted_median(is_res, 0)), 2),
            "wall_s": round(time.time() - t0, 1),
        }
        if args.cross_check:
            t1 = time.time()
            smc = imp.run_smc_prior(log_l, seed=args.seed + 100 + i,
                                    marginalized=True, prior_cfg=prior_cfg)
            out[case]["smc_prior"] = {
                "converged": bool(smc.converged),
                "n_stages": int(smc.n_stages),
                "efficiency": round(float(smc.efficiency), 4),
                "log_evidence_ratio": round(float(smc.log_evidence_ratio),
                                            2),
                "logz_gap_vs_flow_is": round(
                    float(smc.log_evidence_ratio)
                    - out[case]["log_evidence_ratio"], 2),
                "mc_median": round(_mc(_weighted_median(smc, 1)), 2),
                "wall_s": round(time.time() - t1, 1),
            }
        log.info("%s: ess=%.1f eff=%.4f stages=%d logZ=%.2f conv=%s",
                 case, out[case]["ess"], out[case]["efficiency"],
                 out[case]["n_stages"], out[case]["log_evidence_ratio"],
                 out[case]["converged"])

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps({k: {kk: v[kk] for kk in
                          ("ess", "efficiency", "n_stages",
                           "log_evidence_ratio", "converged")}
                      for k, v in out.items()
                      if not k.startswith("_")}, indent=2))
    return out


if __name__ == "__main__":
    main()
