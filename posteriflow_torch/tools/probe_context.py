"""Frozen-encoder probes: what does the context encode?

The port's twin of scripts/probe_context.py. Ridge probes (alpha 1, a
fitted intercept) from the frozen encoder's context to {net SNR, log net
SNR, log distance, chirp mass, t_c, cos theta_jn} on the live events of
--n-events simulated events (batches of 256 on --device), each scored by
4-fold cross-validated R² (unshuffled contiguous folds, the first n % 4
one row longer) and averaged, as scikit-learn's Ridge and
cross_val_score(cv=4, scoring="r2") compute them; here in float64 numpy,
since the card's machine has no scikit-learn.

Usage:
  python -m posteriflow_torch.tools.probe_context --ckpt DIR --out analysis/context_probes.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

BATCH = 256


def ridge_fit(x: np.ndarray, y: np.ndarray, alpha: float = 1.0):
    """Ridge regression with an unpenalized intercept -> (coef, intercept):
    centred x and y, (XᵀX + αI) w = Xᵀy, intercept ȳ − x̄·w."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x_mean, y_mean = x.mean(axis=0), y.mean()
    xc, yc = x - x_mean, y - y_mean
    coef = np.linalg.solve(xc.T @ xc + alpha * np.eye(x.shape[1]), xc.T @ yc)
    return coef, y_mean - x_mean @ coef


def r2_score(y: np.ndarray, pred: np.ndarray) -> float:
    """1 − Σ(y − ŷ)² / Σ(y − ȳ)²."""
    y = np.asarray(y, np.float64)
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot)


def kfold_slices(n: int, k: int = 4):
    """Contiguous unshuffled folds: the first n % k hold n // k + 1 rows."""
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    stops = np.cumsum(sizes)
    return [slice(int(b - s), int(b)) for s, b in zip(sizes, stops)]


def cross_val_r2(x: np.ndarray, y: np.ndarray, alpha: float = 1.0,
                 cv: int = 4) -> np.ndarray:
    """[cv] R² of a ridge probe on each held-out fold."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    out = []
    for test in kfold_slices(len(y), cv):
        train = np.ones(len(y), bool)
        train[test] = False
        coef, b = ridge_fit(x[train], y[train], alpha)
        out.append(r2_score(y[test], x[test] @ coef + b))
    return np.asarray(out)


def probe_targets(theta: np.ndarray, snr: np.ndarray) -> dict:
    """The probed quantities of each event's primary signal."""
    mc = (theta[:, 0] * theta[:, 1]) ** 0.6 / (theta[:, 0]
                                               + theta[:, 1]) ** 0.2
    return {
        "net_snr": snr,
        "log_net_snr": np.log(np.maximum(snr, 1e-3)),
        "log_distance": np.log(theta[:, 2]),
        "chirp_mass": mc,
        "geocent_time": theta[:, 8],
        "cos_theta_jn": np.cos(theta[:, 5]),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-events", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/context_probes.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import torch

    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import load_npe

    dev = torch.device(args.device)
    model, cfg = load_npe(args.ckpt, args.name, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    ctxs, thetas, snrs, nsigs = [], [], [], []
    with torch.no_grad():
        for _ in range(max(1, args.n_events // BATCH)):
            b = simulate_batch(BATCH, cfg.sim, device=dev, generator=gen)
            asd = b.asd_bands if cfg.npe.uses_asd_bands else None
            ctxs.append(model.encode(b.strain, asd).float().cpu().numpy())
            thetas.append(b.params[:, 0, :].cpu().numpy())
            snrs.append(b.net_snr.cpu().numpy())
            nsigs.append(b.n_sig.cpu().numpy())
    ctx = np.concatenate(ctxs)
    theta = np.concatenate(thetas)
    snr = np.concatenate(snrs)
    live = np.concatenate(nsigs) > 0
    ctx, theta, snr = ctx[live], theta[live], snr[live]

    probes = {}
    for name, y in probe_targets(theta, snr).items():
        r2 = float(cross_val_r2(ctx, y).mean())
        probes[name] = r2
        log.info("probe %-14s R2 = %+.3f", name, r2)

    report = {"probes": probes, "n_events": int(live.sum()),
              "context_std_across_events": float(ctx.std(axis=0).mean())}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
