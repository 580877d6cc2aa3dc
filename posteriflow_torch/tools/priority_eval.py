"""PriorityNet evaluation battery -> JSON (the port's twin of
scripts/test_priority_net.py).

Over freshly simulated overlap scenarios (make_priority_batch at the
training config: up to 4 signals, all overlapping, min SNR 6, 5%
candidate jitter, no mining):

  - top-1 extraction-order accuracy and Kendall τ against the true
    loudness order, beside the loudness fallback's;
  - pairwise ordering accuracy binned by the target separation, and the
    same for the oracle that scores by the physics expected SNR of the
    jittered candidate (the ceiling of the parameter channel);
  - uncertainty calibration: the MC-propagated rank displacement
    (rank_uncertainty) against the actual one, and sigma against the score
    error.

    python -m posteriflow_torch.tools.priority_eval \\
        [--model model_release/priority_v7] [--n-batches 20] \\
        [--batch 32] [--device cuda] [--out reports/priority_eval_torch.json]

The defaults (20 batches of 32) give about 500 multi-signal scenarios,
the scale of reports/priority_eval_v7.json. Batch i is drawn from a
generator on the device seeded with (seed, i).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

SEP_BINS = ((0.0, 0.1), (0.1, 0.3), (0.3, 1.0), (1.0, 10.0))


def _seed(seed: int, i: int) -> int:
    return seed * 1_000_003 + i


def evaluate(net, n_batches: int = 20, batch: int = 32, seed: int = 0,
             device="cuda") -> dict:
    """The battery on `net` (a loaded PriorityNet on `device`)."""
    import torch
    from scipy.stats import kendalltau

    from posteriflow_torch.models.priority_net import rank_uncertainty
    from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                        make_priority_batch)

    cfg = dataclasses.replace(PriorityTrainConfig(), batch_size=batch)
    top1 = top1_fb = top1_orc = n_multi = 0
    taus, taus_fb = [], []
    bins = {b: [0, 0] for b in SEP_BINS}
    bins_orc = {b: [0, 0] for b in SEP_BINS}
    sig_err, cand_sig_err, rank_unc_pairs = [], [], []
    for i in range(n_batches):
        gen = torch.Generator(device=device).manual_seed(_seed(seed, i))
        segs, cand, mask, targets, _snr, snr_est = make_priority_batch(
            cfg, gen, device)
        with torch.no_grad():
            scores, sigma = net(segs, cand, mask, snr_est=snr_est)
            ru_gen = torch.Generator(device=device).manual_seed(
                _seed(seed + 31, i))
            ru = rank_uncertainty(scores, sigma, mask,
                                  generator=ru_gen).cpu().numpy()
        scores, sigma = scores.cpu().numpy(), sigma.cpu().numpy()
        mask_np, targets = mask.cpu().numpy(), targets.cpu().numpy()
        cand, snr_est = cand.cpu().numpy(), snr_est.cpu().numpy()
        for b in range(scores.shape[0]):
            live = mask_np[b] > 0
            k = int(live.sum())
            if k < 2:
                continue
            n_multi += 1
            sc, tg, sg = scores[b, live], targets[b, live], sigma[b, live]
            m1, m2, d = (cand[b, live, 0], cand[b, live, 1],
                         cand[b, live, 2])
            loud = ((m1 * m2) ** 0.6 / (m1 + m2) ** 0.2) ** (5.0 / 6.0) \
                / np.maximum(d, 1.0)
            orc = snr_est[b, live]
            true_order = np.argsort(-tg)
            top1 += int(np.argmax(sc) == true_order[0])
            top1_fb += int(np.argmax(loud) == true_order[0])
            top1_orc += int(np.argmax(orc) == true_order[0])
            t = kendalltau(np.argsort(-sc), true_order).statistic
            t_fb = kendalltau(np.argsort(-loud), true_order).statistic
            if np.isfinite(t):
                taus.append(t)
            if np.isfinite(t_fb):
                taus_fb.append(t_fb)
            for a in range(k):
                for c in range(a + 1, k):
                    sep = abs(tg[a] - tg[c])
                    ok = (sc[a] - sc[c]) * (tg[a] - tg[c]) > 0
                    ok_orc = (orc[a] - orc[c]) * (tg[a] - tg[c]) > 0
                    for (lo, hi), acc in bins.items():
                        if lo <= sep < hi:
                            acc[0] += int(ok)
                            acc[1] += 1
                    for (lo, hi), acc in bins_orc.items():
                        if lo <= sep < hi:
                            acc[0] += int(ok_orc)
                            acc[1] += 1
            rank_pred = np.argsort(np.argsort(-sc))
            rank_true = np.argsort(np.argsort(-tg))
            disp = np.abs(rank_pred - rank_true)
            sig_err.append((float(sg.mean()), float(disp.mean())))
            rub = ru[b, live]
            for a in range(k):
                cand_sig_err.append((float(sg[a]), float(abs(sc[a]
                                                             - tg[a]))))
                rank_unc_pairs.append((float(rub[a]), float(disp[a])))

    def corr(pairs):
        pairs = np.asarray(pairs)
        return (float(np.corrcoef(pairs[:, 0], pairs[:, 1])[0, 1])
                if len(pairs) > 3 else None)

    def acc_bins(bs):
        return {f"[{lo},{hi})": (a[0] / a[1] if a[1] else None)
                for (lo, hi), a in bs.items()}

    return {
        "n_scenarios": n_multi,
        "top1": top1 / max(n_multi, 1),
        "kendall_tau": float(np.mean(taus)) if taus else None,
        "kendall_tau_sd": float(np.std(taus)) if taus else None,
        "fallback_top1": top1_fb / max(n_multi, 1),
        "fallback_kendall_tau": float(np.mean(taus_fb)) if taus_fb
        else None,
        "pairwise_acc_by_target_sep": acc_bins(bins),
        "pairs_by_target_sep": {f"[{lo},{hi})": a[1]
                                for (lo, hi), a in bins.items()},
        "oracle_top1": top1_orc / max(n_multi, 1),
        "oracle_pairwise_acc_by_target_sep": acc_bins(bins_orc),
        "uncertainty_error_corr": corr(rank_unc_pairs),
        "uncertainty_event_raw_sigma_corr": corr(sig_err),
        "uncertainty_score_err_corr": corr(cand_sig_err),
        "sigma_spread": (float(np.asarray(cand_sig_err)[:, 0].std())
                         if cand_sig_err else None),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="model_release/priority_v7",
                    help="a release directory (priority_params.msgpack + "
                         "net.json) or a fit_priority output directory")
    ap.add_argument("--n-batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="JSON report path")
    args = ap.parse_args(argv)

    from posteriflow_torch.train.train_priority import load_priority_net
    net = load_priority_net(args.model, device=args.device)
    report = evaluate(net, args.n_batches, args.batch, args.seed,
                      args.device)
    report.update(model=args.model, device=args.device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
