"""Two-channel information bound for PriorityNet's close-pair bin (the
port's twin of scripts/priority_fusion_bound.py).

On the evaluation's natural scenario distribution (make_priority_batch at
the training config), the pairwise ordering accuracy by target
separation of three score-based rankers:

  A. params_oracle: the physics expected SNR of the jittered candidate
     parameters (snr_est);
  B. energy_oracle: the excess power in a merger-centred window of the
     whitened strain, summed over the 3 detectors (w = L/16): Σx² over w
     samples is w + SNR_w² + noise, a phase-free realized-SNR² estimate;
  C. fusion: the inverse-variance mean of A and B in SNR² space,
     var(A) ~ (2 σ_jit SNR²)², var(B) ~ 2·3w + 4 SNR².

    python -m posteriflow_torch.tools.priority_fusion_bound \\
        [--n-batches 10] [--seed 0] [--sigma-jit 0.07] [--device cuda] \\
        [--out reports/priority_fusion_bound_torch.json]

Batch i is drawn from a generator on the device seeded with seed·1,000,003
+ i (the JAX script folds i into PRNGKey(seed)), so the scenarios are the
port's own draws from the same distribution. Prints the report as JSON.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

BINS = ((0.0, 0.1), (0.1, 0.3), (0.3, 1.0))
CHANNELS = ("params_oracle", "energy_oracle", "fusion")


def _key(lo, hi) -> str:
    return f"[{lo},{hi})"


def channel_scores(segs: np.ndarray, snr_est: np.ndarray,
                   sigma_jit: float) -> dict:
    """[B, S, 3, L] segments, [B, S] snr_est -> {channel: [B, S] score}."""
    L = segs.shape[-1]
    w = L // 16
    lo = (L - w) // 2
    e = np.sum(segs[..., lo:lo + w] ** 2, axis=(-1, -2))      # [B, S]
    snr2_data = e - 3 * w                       # 3 detectors of unit noise
    var_b = 2.0 * 3 * w + 4.0 * np.maximum(snr2_data, 0.0)
    snr2_est = snr_est ** 2
    var_a = (2.0 * sigma_jit * np.maximum(snr2_est, 1.0)) ** 2
    fused = (snr2_est / var_a + snr2_data / var_b) \
        / (1.0 / var_a + 1.0 / var_b)
    return {"params_oracle": snr_est, "energy_oracle": snr2_data,
            "fusion": fused}


def run(n_batches: int = 10, seed: int = 0, sigma_jit: float = 0.07,
        device="cuda") -> dict:
    import torch

    from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                        make_priority_batch)
    cfg = PriorityTrainConfig()          # the evaluation's distribution
    acc = {name: {_key(lo, hi): [0, 0] for lo, hi in BINS}
           for name in CHANNELS}
    for i in range(n_batches):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + i)
        segs, _cand, mask, targets, _snr, snr_est = make_priority_batch(
            cfg, gen, device)
        mask_np, tg_all = mask.cpu().numpy(), targets.cpu().numpy()
        scores = channel_scores(segs.cpu().numpy().astype(np.float64),
                                snr_est.cpu().numpy().astype(np.float64),
                                sigma_jit)
        for b in range(mask_np.shape[0]):
            live = mask_np[b] > 0
            k = int(live.sum())
            if k < 2:
                continue
            tg = tg_all[b, live]
            sc = {name: s[b, live] for name, s in scores.items()}
            for a in range(k):
                for c in range(a + 1, k):
                    sep = abs(tg[a] - tg[c])
                    for lo, hi in BINS:
                        if lo <= sep < hi:
                            for name, s in sc.items():
                                ok = (s[a] - s[c]) * (tg[a] - tg[c]) > 0
                                acc[name][_key(lo, hi)][0] += int(ok)
                                acc[name][_key(lo, hi)][1] += 1
    return {
        "n_batches": n_batches,
        "sigma_jit": sigma_jit,
        "window": "L/16 merger-centered, 3-detector summed",
        "pairwise_acc_by_target_sep": {
            name: {k: (v[0] / v[1] if v[1] else None)
                   for k, v in bins.items()}
            for name, bins in acc.items()},
        "n_pairs_by_target_sep": {k: v[1] for k, v in acc["fusion"].items()},
        "n_pairs_close": acc["fusion"][_key(*BINS[0])][1],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--n-batches", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sigma-jit", type=float, default=0.07,
                    help="assumed relative SNR error of channel A")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="reports/priority_fusion_bound_torch.json")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    report = run(args.n_batches, args.seed, args.sigma_jit, args.device)
    report["device"] = args.device
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
