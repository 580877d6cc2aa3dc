"""Overlap benchmark: per-rank calibration and accuracy against the
multiplicity and the merger separation, ranking accuracy and the k-rank
wall time (the port's twin of scripts/overlap_benchmark.py).

For each multiplicity k = 1 .. --max-signals and each of --n-events
events: k signals from the checkpoint's own prior (precessing for a 15-D
release), mergers drawn U(-1.2, 1.2) s, one noisy injection; infer_
overlapping (k ranks of --n-samples draws, host clock around it); per
rank the 50% and 90% coverage of the truth, the chirp-mass fractional
error and the merger-time error of the medians; for k = 2 the rank-0 and
rank-1 90% coverage by merger separation (DT_BINS); for k >= 2 the
ranking's top-1 and Kendall τ against the true loudness order
(rank_overlapping with the released PriorityNet).

    python -m posteriflow_torch.tools.overlap_bench \\
        --ckpt model_release/npe_r7_best [--n-events 100] \\
        [--n-samples 400] [--max-signals 3] [--device cuda] \\
        [--out analysis/overlap_benchmark_torch.json]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

DT_BINS = ((0.0, 0.25), (0.25, 1.0), (1.0, 2.0), (2.0, 3.2))


def _coverage(samples, truth, level):
    lo = np.quantile(samples, 0.5 - level / 2, axis=0)
    hi = np.quantile(samples, 0.5 + level / 2, axis=0)
    return (truth >= lo) & (truth <= hi)


def _chirp_mass(m1, m2):
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def run(engine, n_events: int = 100, n_samples: int = 400,
        max_signals: int = 3, seed: int = 0) -> dict:
    import torch
    from scipy.stats import kendalltau

    from posteriflow_torch.inference.pipeline import infer_overlapping
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.inference.ranking import rank_overlapping
    from posteriflow_torch.prior import (PriorConfig, loudness,
                                         sample_signal_params)

    names = tuple(engine.cfg.param_names)
    pcfg = PriorConfig(precessing=len(names) >= 15)
    dev = engine.device
    rng = np.random.default_rng(seed)
    per_rank, dt_bins_out, runtime = {}, [], {}
    rank_hits = rank_total = kendall_n = 0
    kendall_sum = 0.0

    for n_sig in range(1, max_signals + 1):
        key_r = f"n{n_sig}"
        covs = {r: {"c50": [], "c90": [], "mc_fe": [], "tc_ae": []}
                for r in range(n_sig)}
        times, dt_records = [], []
        for i in range(n_events):
            t0s = rng.uniform(-1.2, 1.2, n_sig)
            gen = torch.Generator(device=dev).manual_seed(
                seed * 1_000_003 + 10 * i + n_sig)
            draws = sample_signal_params((n_sig,), pcfg, generator=gen,
                                         device=dev).cpu().numpy()
            draws[:, 8] = t0s
            prep = prepare_simulated(draws, seed=seed + i,
                                     psd_bands=engine.cfg.psd_bands,
                                     param_names=names, device=dev)
            truth = prep.truth                # loudness-ranked
            n_live = truth.shape[0]
            t0 = time.perf_counter()
            results = infer_overlapping(engine, data=prep, n_signals=n_sig,
                                        n_samples=n_samples, seed=seed + i)
            times.append(time.perf_counter() - t0)

            for r in range(min(n_sig, n_live)):
                s, tr = results[r].samples, truth[r]
                mc_t = _chirp_mass(tr[0], tr[1])
                mc_s = _chirp_mass(s[:, 0], s[:, 1])
                covs[r]["c50"].append(_coverage(s, tr, 0.5))
                covs[r]["c90"].append(_coverage(s, tr, 0.9))
                covs[r]["mc_fe"].append(abs(np.median(mc_s) - mc_t) / mc_t)
                covs[r]["tc_ae"].append(abs(np.median(s[:, 8]) - tr[8]))
            if n_sig == 2 and n_live >= 2:
                dt_records.append((abs(truth[0, 8] - truth[1, 8]),
                                   covs[0]["c90"][-1].mean(),
                                   covs[1]["c90"][-1].mean()))
            if n_sig >= 2 and n_live >= 2:
                order, _ = rank_overlapping(results, prep.strain, device=dev)
                tt = torch.as_tensor(truth)
                true_order = list(np.argsort(-loudness(
                    tt[:, 0], tt[:, 1], tt[:, 2]).numpy()))
                rank_total += 1
                rank_hits += int(order[0] == true_order[0])
                tau = kendalltau(order[:n_live],
                                 true_order[:n_live]).statistic
                if np.isfinite(tau):
                    kendall_sum += tau
                    kendall_n += 1

        runtime[key_r] = float(np.median(times))
        for r in range(n_sig):
            if covs[r]["c50"]:
                per_rank[f"{key_r}_rank{r}"] = {
                    "cov50_mean": float(np.mean(np.stack(covs[r]["c50"]))),
                    "cov90_mean": float(np.mean(np.stack(covs[r]["c90"]))),
                    "mc_frac_err_median": float(np.median(
                        covs[r]["mc_fe"])),
                    "tc_abs_err_median": float(np.median(
                        covs[r]["tc_ae"])),
                    "n": len(covs[r]["c50"])}
        if n_sig == 2 and dt_records:
            arr = np.asarray(dt_records)
            for lo, hi in DT_BINS:
                sel = (arr[:, 0] >= lo) & (arr[:, 0] < hi)
                if sel.any():
                    dt_bins_out.append({
                        "dt_bin": [lo, hi], "n": int(sel.sum()),
                        "rank0_cov90": float(arr[sel, 1].mean()),
                        "rank1_cov90": float(arr[sel, 2].mean())})

    return {"per_rank": per_rank, "dt_bins": dt_bins_out,
            "runtime": runtime,
            "ranking": {"top1": rank_hits / max(rank_total, 1),
                        "kendall_tau": kendall_sum / max(kendall_n, 1),
                        "n": rank_total},
            "n_events_per_multiplicity": n_events, "n_samples": n_samples,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-events", type=int, default=100)
    ap.add_argument("--n-samples", type=int, default=400)
    ap.add_argument("--max-signals", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)

    from posteriflow_torch.inference.pipeline import InferenceEngine
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    report = run(engine, args.n_events, args.n_samples, args.max_signals,
                 args.seed)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
