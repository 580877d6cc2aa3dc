"""Offline calibration audit: coverage at 50/68/90/95, SBC + KS, PP plots,
shuffle-ΔNLL, distance-vs-SNR — figure + JSON outputs.

The port's twin of scripts/npe_diagnostics.py: one simulated batch of
--n-events events drawn from a torch.Generator seeded with --seed, the
diagnostics and calibration metrics of train/, posterior draws for the
coverage and the chirp-mass error by SNR regime, pp.png and sbc.png
(matplotlib), diagnostics.json. As in JAX, the SBC figure and
`sbc_ks_p` name the 11 aligned parameters, so on a 15-D checkpoint they
show the first 11. Everything runs on --device (default cuda).

Usage:
  python -m posteriflow_torch.tools.npe_diagnostics --ckpt DIR --out reports/diag
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
    ap.add_argument("--n-events", type=int, default=512)
    ap.add_argument("--n-post", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default="reports/diag")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import torch

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.data.snr_utils import classify_snr_regime
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.inference.plots import pp_plot, sbc_histograms
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import load_checkpoint_model
    from posteriflow_torch.train.diagnostics import make_diagnostics
    from posteriflow_torch.train.gates import (make_calibration_metrics,
                                               sbc_pass_frac)

    device = torch.device(args.device)
    state_dict, cfg, meta = load_checkpoint_model(args.ckpt, args.name)
    engine = InferenceEngine(state_dict, cfg.npe, device=device)
    model = engine.model

    gen = torch.Generator(device=device).manual_seed(args.seed)
    batch = simulate_batch(args.n_events, cfg.sim, device=device,
                           generator=gen)

    diag = make_diagnostics(cfg, n_events=args.n_events,
                            n_post=args.n_post)(model, batch, generator=gen)
    cal = make_calibration_metrics(cfg, n_events=args.n_events,
                                   n_post=args.n_post)(model, batch,
                                                       generator=gen)
    ranks = cal["sbc_ranks"].cpu().numpy()
    live = cal["live_mask"].cpu().numpy()
    frac, ps = sbc_pass_frac(ranks, live, args.n_post)

    # coverage at several levels (reference audits 50/68/90/95)
    ctx = engine.encode(batch.strain, batch.asd_bands)
    rank0 = torch.zeros(args.n_events, dtype=torch.long, device=device)
    with torch.no_grad():
        theta_s, _, _ = model.sample_from_context(ctx, rank0, args.n_post,
                                                  generator=gen)
    theta_s = theta_s.cpu().numpy()
    truth = batch.params[:, 0, :].cpu().numpy()
    cov = {}
    for lvl in (0.5, 0.68, 0.9, 0.95):
        lo = np.quantile(theta_s, 0.5 - lvl / 2, axis=1)
        hi = np.quantile(theta_s, 0.5 + lvl / 2, axis=1)
        inside = ((truth >= lo) & (truth <= hi)) * live[:, None]
        cov[str(lvl)] = (inside.sum(0) / max(live.sum(), 1)).round(3).tolist()

    # error vs SNR regime (extended eval)
    snr = batch.net_snr.cpu().numpy()
    safe = np.maximum(truth[:, :2], 1.0)    # dead slots are zero-filled
    mc_t = (safe[:, 0] * safe[:, 1]) ** 0.6 / (safe[:, 0]
                                               + safe[:, 1]) ** 0.2
    mc_s = (theta_s[:, :, 0] * theta_s[:, :, 1]) ** 0.6 \
        / (theta_s[:, :, 0] + theta_s[:, :, 1]) ** 0.2
    mc_err = np.abs(np.median(mc_s, axis=1) - mc_t) / np.maximum(mc_t, 1e-9)
    by_regime = {}
    for i in range(args.n_events):
        if live[i] < 1:
            continue
        r = classify_snr_regime(float(snr[i]))
        by_regime.setdefault(r, []).append(float(mc_err[i]))
    regime_err = {k: {"mc_frac_err_median": float(np.median(v)), "n": len(v)}
                  for k, v in by_regime.items()}

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    pp_plot(ranks, live, args.n_post, outdir / "pp.png")
    sbc_histograms(ranks[live > 0], args.n_post, outdir / "sbc.png")

    report = {
        "checkpoint": str(Path(args.ckpt) / args.name),
        "epoch": meta.get("epoch"),
        "shuffle_delta_nll": float(diag["shuffle_delta_nll"]),
        "dist_corr": float(diag["dist_corr"]),
        "coverage": cov,
        "sbc_pass_frac": frac,
        "sbc_ks_p": dict(zip(PARAM_NAMES, np.round(ps, 5).tolist())),
        "spurious_railing": float(cal["spurious_railing"]),
        "base_conc": float(cal["base_conc"]),
        "mc_err_by_snr_regime": regime_err,
        "n_events": args.n_events, "n_post": args.n_post,
    }
    (outdir / "diagnostics.json").write_text(json.dumps(report, indent=2))
    log.info("shuffle-dNLL %.2f | dist_corr %.2f | SBC pass %.2f | "
             "railing %.3f -> %s", report["shuffle_delta_nll"],
             report["dist_corr"], frac, report["spurious_railing"], outdir)
    return report


if __name__ == "__main__":
    main()
