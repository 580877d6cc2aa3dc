"""The long-BNS gate battery -> JSON report + exit code.

The port's twin of scripts/validate_long_bns.py, with its gates, flags
and report keys. On fixed seeded events, in chunks (rounded up, as JAX
does), over the 11 aligned parameters of the BNS prior:

  - v1 and v3: context-shuffle ΔNLL > 5 nats; v4: signal ΔNLL > 2 nats (the NLL
    gap between noise-only and signal tokens at the same θ, trigger and
    noise) and mc_sharpen < 0.8 (the median ratio of the posterior's
    chirp-mass std to the trigger's residual prior, σ_mc·M̂c)
  - 50%/90% central-interval coverage within ±0.07/±0.05 (<=2 of 11
    excepted)
  - SBC KS p > 1e-3 for >= 9/11 parameters
  - spurious railing < 5%
  - distance correlation (log median vs log truth) > 0.5

The model directory holds calibration.json and the weights: a JAX
release's params.msgpack or a port run's state.pt (tools/train_long_bns.py).
A v4 model is served on the trigger grid in its directory (grid.npz, which
a port run writes) or else on the grid stored for its tokens config
(models/grids/); a config with neither raises. A v3 ("chirp") model's grid
is rebuilt from its config, as the JAX script rebuilds it.

The draws of chunk i come from a torch.Generator seeded with
seed·1_000_003 + i; the streams are not JAX's, so the figures agree with a
JAX report statistically, not bit for bit. Everything runs on --device
(default cuda).

Usage: python -m posteriflow_torch.tools.validate_long_bns \\
           --model model_release/long_bns_v4 [--n-events 2000] \\
           [--n-post 400] [--chunk 50] [--device cpu] --out DIR
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import time
from pathlib import Path

import numpy as np

GATES = {
    "shuffle_delta_nll": (">", 5.0),
    "cov50_violations": ("<=", 2),
    "cov90_violations": ("<=", 2),
    "sbc_pass_frac": (">=", 9.0 / 11.0),
    "spurious_railing": ("<", 0.05),
    "dist_corr": (">", 0.5),
}

# v4 (trigger-relative labels): the θ-shuffle tests trigger-label
# consistency, not strain use, so the conditioning gates are the signal
# ΔNLL and the chirp-mass sharpening
GATES_V4 = {
    "signal_delta_nll": (">", 2.0),
    "mc_sharpen": ("<", 0.8),
    "cov50_violations": ("<=", 2),
    "cov90_violations": ("<=", 2),
    "sbc_pass_frac": (">=", 9.0 / 11.0),
    "spurious_railing": ("<", 0.05),
    "dist_corr": (">", 0.5),
}


def _check(name, value, spec):
    op, thresh = spec
    ok = {"<": value < thresh, "<=": value <= thresh,
          ">": value > thresh, ">=": value >= thresh}[op]
    return {"gate": name, "value": float(value), "op": op,
            "threshold": thresh, "passed": bool(ok)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--model", default="model/long_bns_v2")
    ap.add_argument("--n-events", type=int, default=2000)
    ap.add_argument("--n-post", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--seed", type=int, default=4321)
    ap.add_argument("--out", default="reports/val_long_bns")
    ap.add_argument("--device", default="cuda")
    return ap


def chunk_stats(model, cal_cfg: dict, grid, gen, n_events: int, n_post: int,
                device) -> tuple:
    """One chunk of JAX's chunk_metrics -> (scalars, arrays, seconds by
    part). The draws (θ, noise, trigger errors, base draws) come from
    `gen`."""
    import torch

    from posteriflow_torch.models import long_bns as lb
    from posteriflow_torch.scaler import ParamScaler

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    kind = lb.model_config(cal_cfg)["kind"]
    v4 = kind == "trigger"
    t0 = time.perf_counter()
    if v4:
        draws = lb.draw_long_bns(n_events, grid["cut"], grid["trunc"], gen,
                                 device)
        tokens, theta, trig = lb.simulate_long_bns_v4_from_draws(draws, grid)
        tok0, _, _ = lb.simulate_long_bns_v4_from_draws(draws, grid, 0.0)
    elif kind == "chirp":
        tokens, theta = lb.simulate_long_bns_batch_v3(n_events, grid, gen,
                                                      device)
    else:
        sim = dict(duration=cal_cfg["duration"], n_bands=cal_cfg["n_bands"],
                   per_band=cal_cfg["per_band"])
        tokens, theta = lb.simulate_long_bns_batch(n_events, **sim,
                                                   generator=gen,
                                                   device=device)
    sync()
    t1 = time.perf_counter()
    if v4:
        nll = model(tokens, theta, trig)
        # the conditioning counterfactual: same θ, trigger and noise,
        # signal removed
        nll_alt = model(tok0, theta, trig)
    else:
        nll = model(tokens, theta)
        nll_alt = model(tokens, torch.roll(theta, 1, dims=0))
    nll, nll_alt = float(nll), float(nll_alt)
    t2 = time.perf_counter()
    if v4:
        draws_s, y_raw = model.sample_raw(tokens, trig, n_post, gen)
    else:
        draws_s, y_raw = model.sample_raw(tokens, n_post, gen)
    sync()
    t3 = time.perf_counter()
    if v4:
        mc_d = lb.chirp_mass(draws_s[..., 0], draws_s[..., 1])
        # jnp.median: the mean of the middle two of an even count
        mc_sharpen = float(torch.quantile(
            torch.std(mc_d, dim=1, unbiased=False)
            / (cal_cfg["tokens"]["sigma_mc_rel"] * trig[:, 0]), 0.5))
    else:
        mc_sharpen = 0.0
    q = torch.tensor([0.25, 0.75, 0.05, 0.95, 0.5], device=draws_s.device)
    lo50, hi50, lo90, hi90, med = torch.quantile(draws_s, q, dim=1)
    in50 = ((theta >= lo50) & (theta <= hi50)).float()
    in90 = ((theta >= lo90) & (theta <= hi90)).float()
    rank = torch.sum((draws_s < theta[:, None, :]).int(), dim=1)
    railed = ParamScaler().railing_mask(y_raw)
    arrays = {"in50": in50.cpu().numpy(), "in90": in90.cpu().numpy(),
              "rank": rank.cpu().numpy(),
              "lmed": torch.log(med[:, 2]).cpu().numpy(),
              "ltrue": torch.log(theta[:, 2]).cpu().numpy()}
    scalars = {"nll": nll, "nll_alt": nll_alt,
               "railing": float(railed.float().mean()),
               "mc_sharpen": mc_sharpen,
               "dist_corr": float(np.corrcoef(arrays["lmed"],
                                              arrays["ltrue"])[0, 1])}
    t4 = time.perf_counter()
    return scalars, arrays, {"simulate": t1 - t0, "nll": t2 - t1,
                             "sampling": t3 - t2, "statistics": t4 - t3}


def run(argv=None):
    """main's body -> (exit code, report, record). The record holds each
    chunk's scalars (its NLLs, railing, mc_sharpen and distance
    correlation) and the seconds by part (simulate, NLL, sampling,
    statistics) summed over the chunks."""
    args = _parser().parse_args(argv)

    import torch
    from scipy.stats import kstest

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.train.checkpoints import load_long_bns
    from posteriflow_torch.utils.logging import setup_logging
    from posteriflow_torch.utils.provenance import config_hash

    log = setup_logging()
    device = torch.device(args.device)
    mdir = Path(args.model)
    model, cal_cfg, grid = load_long_bns(mdir, device=device)
    model.eval()
    kind = cal_cfg.get("tokens", {}).get("kind", "v1")
    is_v4 = kind == "trigger"
    log.info("loaded %s (%s tokens) on %s", mdir, kind, device)

    t0 = time.time()
    n_chunks = max(1, -(-args.n_events // args.chunk))
    chunks, arrays = [], []
    seconds = {"simulate": 0.0, "nll": 0.0, "sampling": 0.0,
               "statistics": 0.0}
    with torch.no_grad():
        for i in range(n_chunks):
            gen = torch.Generator(device=device).manual_seed(
                args.seed * 1_000_003 + i)
            s, a, sec = chunk_stats(model, cal_cfg, grid, gen, args.chunk,
                                    args.n_post, device)
            chunks.append(s)
            arrays.append(a)
            for k, v in sec.items():
                seconds[k] += v
            if i == 0:
                log.info("first chunk %.1fs", time.time() - t0)

    def cat(key):
        return np.concatenate([a[key] for a in arrays])

    cov50, cov90 = cat("in50").mean(0), cat("in90").mean(0)
    rk = cat("rank")
    lmed, ltrue = cat("lmed"), cat("ltrue")
    nlls = [c["nll"] for c in chunks]
    alts = [c["nll_alt"] for c in chunks]
    sbc_p = [float(kstest((rk[:, j] + 0.5) / (args.n_post + 1),
                          "uniform").pvalue) for j in range(11)]
    delta_name = "signal_delta_nll" if is_v4 else "shuffle_delta_nll"
    t_stats = time.time()
    metrics = {
        "val_nll": float(np.mean(nlls)),
        delta_name: float(np.mean(alts) - np.mean(nlls)),
        "cov50_all": dict(zip(PARAM_NAMES, np.round(cov50, 4).tolist())),
        "cov90_all": dict(zip(PARAM_NAMES, np.round(cov90, 4).tolist())),
        "cov50_violations": int(np.sum(np.abs(cov50 - 0.5) > 0.07)),
        "cov90_violations": int(np.sum(np.abs(cov90 - 0.9) > 0.05)),
        "sbc_ks_p": dict(zip(PARAM_NAMES, [round(p, 6) for p in sbc_p])),
        "sbc_pass_frac": float(np.mean(np.asarray(sbc_p) > 1e-3)),
        "spurious_railing": float(np.mean([c["railing"] for c in chunks])),
        "dist_corr": float(np.corrcoef(lmed, ltrue)[0, 1]),
        "n_events_nominal": args.n_events,
        "n_events": int(n_chunks * args.chunk),
        "n_post": args.n_post,
        "wall_s": round(time.time() - t0, 1),
    }
    if is_v4:
        metrics["mc_sharpen"] = float(np.median([c["mc_sharpen"]
                                                 for c in chunks]))
    seconds["statistics"] += time.time() - t_stats
    gates = GATES_V4 if is_v4 else GATES
    checks = [_check(name, metrics[name], spec)
              for name, spec in gates.items()]
    passed = all(c["passed"] for c in checks)
    report = {
        "passed": passed,
        "checks": checks,
        "metrics": metrics,
        "checkpoint": str(mdir),
        "_meta": {
            "ckpt": str(mdir),
            "generated_utc": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
            "config_hash": config_hash(cal_cfg),
            "param_names": list(PARAM_NAMES),
        },
    }
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "report.json").write_text(json.dumps(report, indent=2))
    for c in checks:
        log.info("%-22s %10.4f %2s %-8s %s", c["gate"], c["value"],
                 c["op"], c["threshold"], "PASS" if c["passed"] else "FAIL")
    print(json.dumps({"passed": passed, "val_nll": metrics["val_nll"],
                      "out": str(outdir / "report.json")}))
    record = {"chunks": chunks, "seconds": seconds}
    return (0 if passed else 1), report, record


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
