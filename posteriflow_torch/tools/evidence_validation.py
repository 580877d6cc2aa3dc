"""Evidence validation against analytic truths (the port's twin of
scripts/evidence_validation.py): the flow-IS evidence estimator is exact
given a good proposal, and the prior-SMC and nested samplers' logZ
deficits are their random-walk volume biases.

Part A (synthetic, 4 dims): a Gaussian likelihood over four uniform-prior
dims (psi, geocent_time, a1, a2) of the 11-D prior has the analytic
evidence Z = Π_i (σ_i √(2π) / w_i)·[Φ((hi−μ)/σ) − Φ((lo−μ)/σ)]. Measured:
  1. IS from a well-matched proposal (the prior with 1.5σ Gaussians on the
     likelihood dims), numpy throughout; sample_prior_bbh makes the JAX
     package's calls on the same default_rng, so these are JAX's numbers;
  2. tempered prior-SMC (importance._tempered_is, run_smc_prior's
     machinery, the log prior on --device) at walk lengths n_mcmc in
     {1, 3, 10, 30}: short walks bias logZ low.
Part C (synthetic, 15-D precessing space): a Gaussian over seven dims
whose priors are closed-form marginals (the sine prior of tilt_1 by 1-D
quadrature): matched-proposal IS, prior-SMC against n_mcmc, and the
fallback nested sampler at nlive 400 and 800.
Part B (--real, a release): one injection; flow-IS logZ
(importance_correct on the marginalized Whittle likelihood) against
run_smc_prior at n_mcmc in {2, 5, 15, 40}, on --device.

    python -m posteriflow_torch.tools.evidence_validation [--device cuda] \\
        [--real --release model_release/npe_r5_best] \\
        [--out analysis/evidence_validation_torch.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import time
from pathlib import Path

import numpy as np

# likelihood dims (PARAM_NAMES indices), centres, widths, prior boxes
_L_DIMS = (6, 8, 9, 10)                 # psi, geocent_time, a1, a2
_MU = (1.1, 0.25, 0.40, 0.30)
_SIG = (0.05, 0.02, 0.03, 0.03)
_BOX = ((0.0, math.pi), (-1.5, 1.5), (0.0, 0.99), (0.0, 0.99))
N_MCMC_GRID = (1, 3, 10, 30)
NLIVE_GRID = (400, 800)
REAL_N_MCMC_GRID = (2, 5, 15, 40)

_L15 = {  # idx: (mu, sigma, lo, hi, prior)
    6: (1.10, 0.05, 0.0, math.pi, "uniform"),         # psi
    8: (0.25, 0.02, -1.5, 1.5, "uniform"),            # geocent_time
    9: (0.40, 0.03, 0.0, 0.99, "uniform"),            # a1
    10: (0.30, 0.03, 0.0, 0.99, "uniform"),           # a2
    11: (1.20, 0.10, 0.0, math.pi, "sin"),            # tilt_1
    13: (2.50, 0.15, 0.0, 2 * math.pi, "uniform"),    # phi_12
    14: (4.00, 0.15, 0.0, 2 * math.pi, "uniform"),    # phi_jl
}


def _truth_logz() -> float:
    from scipy.stats import norm
    lz = 0.0
    for mu, sig, (lo, hi) in zip(_MU, _SIG, _BOX):
        frac = norm.cdf((hi - mu) / sig) - norm.cdf((lo - mu) / sig)
        lz += math.log(sig * math.sqrt(2 * math.pi) * frac / (hi - lo))
    return lz


def synthetic_log_l(theta):
    """Un-normalized Gaussian log-likelihood over the four dims, over
    [..., 11] or [..., 15]."""
    th = np.asarray(theta, dtype=np.float64)
    out = 0.0
    for d, mu, sig in zip(_L_DIMS, _MU, _SIG):
        out = out - (th[..., d] - mu) ** 2 / (2.0 * sig * sig)
    return out


def synthetic_log_l_15(theta):
    th = np.asarray(theta, dtype=np.float64)
    out = 0.0
    for d, (mu, sig, *_rest) in _L15.items():
        out = out - (th[..., d] - mu) ** 2 / (2.0 * sig * sig)
    return out


def _truth_logz_15() -> float:
    from scipy.integrate import quad
    from scipy.stats import norm
    lz = 0.0
    for mu, sig, lo, hi, kind in _L15.values():
        if kind == "uniform":
            frac = norm.cdf((hi - mu) / sig) - norm.cdf((lo - mu) / sig)
            lz += math.log(sig * math.sqrt(2 * math.pi) * frac / (hi - lo))
        else:                                    # sine prior (tilt_1)
            val, err = quad(
                lambda t: math.exp(-(t - mu) ** 2 / (2 * sig * sig))
                * math.sin(t) / 2.0, lo, hi,
                points=[mu - 5 * sig, mu, mu + 5 * sig], limit=200)
            if not err < 1e-8 * val:
                raise RuntimeError(f"tilt_1 quadrature error {err}")
            lz += math.log(val)
    return lz


def _matched_is(rng, n: int, n_rep: int, pcfg, dims, log_l,
                truth: float) -> dict:
    """IS from the prior with 1.5σ Gaussians on the likelihood dims:
    dims = [(idx, mu, sig, lo, hi, prior)]."""
    from posteriflow_torch.prior import sample_prior_bbh
    logz = []
    for _ in range(n_rep):
        th = sample_prior_bbh(rng, n, pcfg)
        log_corr = np.zeros(n)
        for d, mu, sig, lo, hi, kind in dims:
            s = 1.5 * sig
            x = np.clip(rng.normal(mu, s, n), lo + 1e-9, hi - 1e-9)
            th[:, d] = x
            lp_marg = (-math.log(hi - lo) if kind == "uniform"
                       else np.log(np.sin(x) / 2.0))
            log_corr += lp_marg - (-math.log(s * math.sqrt(2 * math.pi))
                                   - (x - mu) ** 2 / (2 * s * s))
        lw = log_l(th) + log_corr
        m = lw.max()
        logz.append(float(np.log(np.mean(np.exp(lw - m))) + m))
    return {"logz_mean": float(np.mean(logz)),
            "logz_std": float(np.std(logz)),
            "bias": float(np.mean(logz) - truth), "n_rep": n_rep}


def _smc_sweep(n: int, n_rep: int, pcfg, log_l, truth: float, device,
               grid=N_MCMC_GRID) -> list:
    """Tempered prior-SMC (host moves) at each walk length of `grid`."""
    from posteriflow_torch.inference.importance import (_tempered_is,
                                                        host_log_prior)
    from posteriflow_torch.prior import sample_prior_bbh
    log_prior_fn = host_log_prior(pcfg, device)
    out = []
    for n_mcmc in grid:
        runs = []
        t0 = time.time()
        for rep in range(n_rep):
            rng = np.random.default_rng(1000 * rep + n_mcmc)
            theta = sample_prior_bbh(rng, n, pcfg)
            lp = np.asarray(log_prior_fn(theta), np.float64)
            ll = log_l(theta)
            r = _tempered_is(theta, lp.copy(), ll, lp, log_l, log_prior_fn,
                             n_mcmc=n_mcmc, max_stages=60,
                             seed=rep + 17 * n_mcmc)
            runs.append(float(r.log_evidence_ratio))
        out.append({"n_mcmc": n_mcmc, "logz_mean": float(np.mean(runs)),
                    "logz_std": float(np.std(runs)),
                    "bias": float(np.mean(runs) - truth),
                    "wall_s": round(time.time() - t0, 1)})
    return out


def part_a(n: int = 4096, seed: int = 0, n_rep: int = 3,
           device="cuda") -> dict:
    from posteriflow_torch.prior import PriorConfig
    truth = _truth_logz()
    dims = [(d, mu, sig, lo, hi, "uniform")
            for d, mu, sig, (lo, hi) in zip(_L_DIMS, _MU, _SIG, _BOX)]
    return {"truth_logz": truth, "n_particles": n,
            "is_good_proposal": _matched_is(np.random.default_rng(seed), n,
                                            n_rep, PriorConfig(), dims,
                                            synthetic_log_l, truth),
            "prior_smc_vs_walk_length": _smc_sweep(
                n, n_rep, PriorConfig(), synthetic_log_l, truth, device)}


def part_c(n: int = 4096, seed: int = 0, n_rep: int = 3,
           nlive_grid=NLIVE_GRID, device="cuda") -> dict:
    from posteriflow_torch.inference.dynesty_bridge import run_dynesty
    from posteriflow_torch.prior import PriorConfig
    pcfg = PriorConfig(precessing=True)
    truth = _truth_logz_15()
    dims = [(d, *v) for d, v in _L15.items()]
    out = {"truth_logz": truth, "n_particles": n, "ndim": 15,
           "is_good_proposal": _matched_is(np.random.default_rng(seed), n,
                                           n_rep, pcfg, dims,
                                           synthetic_log_l_15, truth),
           "prior_smc_vs_walk_length": _smc_sweep(
               n, n_rep, pcfg, synthetic_log_l_15, truth, device)}
    nested = []
    for nlive in nlive_grid:
        t0 = time.time()
        r = run_dynesty(synthetic_log_l_15, nlive=nlive, seed=seed,
                        maxiter=200000, ndim=15)
        nested.append({"nlive": nlive, "logz": float(r["logz"]),
                       "bias": float(r["logz"] - truth),
                       "n_like_calls": int(r.get("n_like_calls", -1)),
                       "sampler": r.get("sampler", "fallback"),
                       "wall_s": round(time.time() - t0, 1)})
    out["nested_vs_nlive"] = nested
    return out


REAL_INJECTION = {"mass_1": 36.0, "mass_2": 29.0,
                  "luminosity_distance": 420.0, "ra": 1.4, "dec": 0.3,
                  "theta_jn": 0.6, "psi": 0.7, "phase": 1.2,
                  "geocent_time": 0.1, "a1": 0.3, "a2": 0.2}


def part_b(release: str, n_mcmc_grid=REAL_N_MCMC_GRID, seed: int = 0,
           device="cuda") -> dict:
    """One injection: flow-IS logZ against prior-SMC logZ at increasing
    walk length, on the marginalized Whittle likelihood on `device`."""
    from posteriflow_torch.inference.importance import (
        importance_correct, make_marginalized_log_likelihood, run_smc_prior)
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.prior import PriorConfig

    engine = InferenceEngine.from_checkpoint(release, device=device)
    names = tuple(engine.cfg.param_names)
    prepared = prepare_simulated([REAL_INJECTION], seed=seed,
                                 psd_bands=engine.cfg.psd_bands,
                                 param_names=names, device=device)
    npe = infer(engine, data=prepared, n_samples=4096, seed=seed)
    log_l = make_marginalized_log_likelihood(prepared.strain, device=device)
    ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
    t0 = time.time()
    is_res = importance_correct(engine, ctx[0], 0, npe.samples,
                                npe.log_prob, npe.railed, log_l,
                                marginalized=True, seed=seed)
    flow_logz = float(is_res.log_evidence_ratio)
    out = {"injection": REAL_INJECTION,
           "flow_is": {"logz": flow_logz,
                       "efficiency": float(is_res.efficiency),
                       "n_stages": int(is_res.n_stages),
                       "converged": bool(is_res.converged),
                       "wall_s": round(time.time() - t0, 1)}}
    pcfg = PriorConfig(precessing=len(names) >= 15)
    grid = []
    for n_mcmc in n_mcmc_grid:
        t0 = time.time()
        r = run_smc_prior(log_l, seed=seed, marginalized=True,
                          prior_cfg=pcfg, n_mcmc=n_mcmc)
        grid.append({"n_mcmc": n_mcmc,
                     "logz": float(r.log_evidence_ratio),
                     "gap_vs_flow_is": float(r.log_evidence_ratio
                                             - flow_logz),
                     "converged": bool(r.converged),
                     "n_stages": int(r.n_stages),
                     "wall_s": round(time.time() - t0, 1)})
        print(f"prior-SMC n_mcmc={n_mcmc}: logZ={grid[-1]['logz']:.2f} "
              f"(gap {grid[-1]['gap_vs_flow_is']:+.2f})")
    out["prior_smc_vs_walk_length"] = grid
    out["release"] = release
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--release", default="model_release/npe_r5_best")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="analysis/evidence_validation_torch.json")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    report = {"_meta": {"script": "posteriflow_torch/tools/"
                                  "evidence_validation.py",
                        "seed": args.seed, "device": args.device}}
    print("Part A: synthetic Gaussian likelihood, analytic logZ")
    report["synthetic"] = t = part_a(n=args.n, seed=args.seed,
                                     device=args.device)
    print(f"truth logZ = {t['truth_logz']:.4f}; good-proposal IS bias = "
          f"{t['is_good_proposal']['bias']:+.4f} ± "
          f"{t['is_good_proposal']['logz_std']:.4f}")
    for row in t["prior_smc_vs_walk_length"]:
        print(f"prior-SMC n_mcmc={row['n_mcmc']:3d}: "
              f"bias {row['bias']:+.3f} ± {row['logz_std']:.3f}")
    print("Part C: 15-D precessing-space synthetic, quadrature-exact logZ")
    report["synthetic_15d"] = c = part_c(n=args.n, seed=args.seed,
                                         device=args.device)
    print(f"15-D truth logZ = {c['truth_logz']:.4f}; matched-proposal IS "
          f"bias = {c['is_good_proposal']['bias']:+.4f} ± "
          f"{c['is_good_proposal']['logz_std']:.4f}")
    for row in c["prior_smc_vs_walk_length"]:
        print(f"  15-D prior-SMC n_mcmc={row['n_mcmc']:3d}: "
              f"bias {row['bias']:+.3f} ± {row['logz_std']:.3f}")
    for row in c["nested_vs_nlive"]:
        print(f"  15-D nested nlive={row['nlive']}: bias "
              f"{row['bias']:+.3f} ({row['wall_s']}s)")
    if args.real:
        report["real_case"] = part_b(args.release, seed=args.seed,
                                     device=args.device)
        report["_meta"]["ckpt"] = args.release
        meta_p = Path(args.release) / "meta.json"
        if meta_p.exists():
            cfg = json.loads(meta_p.read_text()).get("config", {})
            report["_meta"]["config_hash"] = hashlib.sha256(
                json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:12]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
