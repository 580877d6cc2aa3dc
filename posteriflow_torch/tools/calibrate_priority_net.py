"""Post-hoc affine calibration of PriorityNet scores (the port's twin of
scripts/calibrate_priority_net.py).

Scores a PriorityNet on freshly simulated overlap scenarios
(make_priority_batch at the training config), keeps the live candidates'
(score, target) pairs and fits core/calibrator.OutputCalibrator on them in
one of its three modes: "learned" (least squares), "minmax" or
"percentile" (5th-95th). Reports the gain, the bias and the mean absolute
error before and after.

    python -m posteriflow_torch.tools.calibrate_priority_net \\
        --params model_release/priority_v7 [--mode learned] \\
        [--n-batches 10] [--seed 99] [--device cuda] [--out FILE]

--params takes a priority_params.msgpack, a release directory or a
fit_priority output directory; its net.json sets the architecture
(--d-model otherwise). Batch i is drawn from a generator on the device
seeded with seed·1,000,003 + i (JAX folds i into PRNGKey(seed)). The
report goes to --out, by default calibration_torch.json beside the
weights (the JAX script writes calibration.json there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

MODES = ("learned", "minmax", "percentile")


def collect_scores(net, n_batches: int = 10, seed: int = 99,
                   device="cuda", batch: int = 32):
    """-> (scores, targets) of the live candidates over n_batches batches of
    `batch` scenarios, as float numpy arrays."""
    import torch

    from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                        make_priority_batch)
    cfg = dataclasses.replace(PriorityTrainConfig(d_model=net.d_model),
                              batch_size=batch)
    s_all, t_all = [], []
    for i in range(n_batches):
        gen = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + i)
        segs, cand, mask, targets, _snr, snr_est = make_priority_batch(
            cfg, gen, device)
        with torch.no_grad():
            scores, _ = net(segs, cand, mask, snr_est=snr_est)
        live = mask.cpu().numpy() > 0
        s_all.append(scores.cpu().numpy()[live])
        t_all.append(targets.cpu().numpy()[live])
    return np.concatenate(s_all), np.concatenate(t_all)


def calibrate(scores: np.ndarray, targets: np.ndarray,
              mode: str = "learned") -> dict:
    """Fit OutputCalibrator in `mode` -> the JAX script's report keys."""
    from posteriflow_torch.core.calibrator import OutputCalibrator
    cal = OutputCalibrator().fit(scores, targets, mode=mode)
    return {"gain": float(cal.gain), "bias": float(cal.bias),
            "mode": cal.mode,
            "mae_before": float(np.abs(scores - targets).mean()),
            "mae_after": float(np.abs(cal(scores) - targets).mean()),
            "n_pairs": int(len(scores))}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--params", required=True,
                    help="priority_params.msgpack, a release directory or "
                         "a fit_priority output directory")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-batches", type=int, default=10)
    ap.add_argument("--mode", default="learned", choices=MODES)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from posteriflow_torch.train.train_priority import load_priority_net
    from posteriflow_torch.utils.logging import setup_logging
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    log = setup_logging()
    net = load_priority_net(args.params, d_model=args.d_model,
                            device=args.device)
    s, t = collect_scores(net, args.n_batches, args.seed, args.device)
    report = calibrate(s, t, args.mode)
    log.info("affine fit: g=%.3f b=%.3f | MAE %.3f -> %.3f", report["gain"],
             report["bias"], report["mae_before"], report["mae_after"])
    params = Path(args.params)
    out = Path(args.out or ((params if params.is_dir() else params.parent)
                            / "calibration_torch.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
