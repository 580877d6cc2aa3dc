"""Robustness check: design-whitened signals in real (or real-like) noise
crops, the NLL and coverage gap against the Gaussian domain.

The port's twin of scripts/real_noise_test.py. The same events (one
generator seed) are simulated twice on --device: in Gaussian noise, and
at real_noise_prob 1 on a noise bank (--bank, or a synthetic bank of 4
segments). The batch NLL of each and the diagnostics' distance
correlation and 90% coverage are reported; a real-vs-Gaussian NLL gap
under 3 nats passes the gate. --ckpt is a CheckpointManager root (the
checkpoint --name) or a release directory.

Usage:
  python -m posteriflow_torch.tools.real_noise_test --ckpt DIR [--bank DIR] [--n-events 256]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

NLL_GAP_GATE = 3.0


def run(argv=None):
    """main's body -> (report, {"gaussian": batch, "real": batch})."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--bank", default=None,
                    help="noise bank dir (default: synthetic bank)")
    ap.add_argument("--n-events", type=int, default=256)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import dataclasses

    import torch

    from posteriflow_torch.data.noise_bank import (load_noise_bank,
                                                   make_synthetic_bank)
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import load_npe
    from posteriflow_torch.train.diagnostics import make_diagnostics
    from posteriflow_torch.train.trainer import make_eval_nll

    dev = torch.device(args.device)
    model, cfg = load_npe(args.ckpt, args.name, dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    bank = (load_noise_bank(args.bank, device=dev) if args.bank
            else make_synthetic_bank(gen(0), n_segments=4, device=dev))
    with torch.no_grad():
        gauss = simulate_batch(args.n_events, cfg.sim, device=dev,
                               generator=gen(args.seed))
        real_cfg = dataclasses.replace(cfg.sim, real_noise_prob=1.0)
        real = simulate_batch(args.n_events, real_cfg, device=dev,
                              generator=gen(args.seed), bank=bank)

    eval_nll = make_eval_nll(cfg)
    diag = make_diagnostics(cfg, n_events=args.n_events)
    g_nll = eval_nll(model, gauss)
    r_nll = eval_nll(model, real)
    g_d = diag(model, gauss, generator=gen(args.seed))
    r_d = diag(model, real, generator=gen(args.seed))

    report = {
        "gaussian_nll": g_nll, "real_nll": r_nll,
        "nll_gap": r_nll - g_nll,
        "gap_within_gate": bool(abs(r_nll - g_nll) < NLL_GAP_GATE),
        "gaussian_dist_corr": float(g_d["dist_corr"]),
        "real_dist_corr": float(r_d["dist_corr"]),
        "gaussian_cov90": float(g_d["dist_cov90"]),
        "real_cov90": float(r_d["dist_cov90"]),
        "bank": args.bank or "synthetic",
        "n_events": args.n_events,
    }
    log.info("NLL gap %.2f nats (gate <3): %s", report["nll_gap"],
             "PASS" if report["gap_within_gate"] else "FAIL")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report, {"gaussian": gauss, "real": real}


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
