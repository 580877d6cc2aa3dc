"""Nested-sampler convergence study on the asym_q anchor (the port's twin
of scripts/anchor_convergence.py).

Reruns the fallback nested sampler at increasing effort (GRID: nlive ×
walks) on one fixed asym_q injection (analysis/anchors.json's) and
records each logZ beside the flow-IS evidence on the same data: a logZ
that climbs toward IS with effort says the random-walk sampler misses
likelihood volume (it biases logZ low); a stable gap would say IS is
biased high.

    python -m posteriflow_torch.tools.anchor_convergence \\
        [--ckpt model_release/npe_r7_best] [--seed 777] [--device cuda] \\
        [--out analysis/anchor_convergence_torch.json]

The default --ckpt is the release of config hash b58b05b3ce29, the model
behind the JAX report (whose model/npe_r7/ckpt is not committed). Every
likelihood call goes through `_chunked`, which evaluates at the JAX
script's two batch shapes: 24 rows (the sampler's walk steps) and blocks
of CHUNK rows, the last padded with copies of the first row. The report
resumes: runs already in --out for the same seed are kept.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

# (nlive, walks, maxiter): maxiter sized so that dlogz, not the iteration
# cap, ends each run
GRID = [
    (400, 24, 12000),
    (400, 48, 12000),
    (800, 24, 24000),
    (1600, 24, 48000),
]
CHUNK = 400


def _chunked(log_l, chunk=CHUNK, small=24):
    """log_l evaluated at two batch shapes only: (small,) as it is, larger
    batches in (chunk,)-blocks, the last padded with its first row."""
    def wrapped(theta):
        theta = np.asarray(theta, dtype=np.float32)
        n = theta.shape[0]
        if n == small:
            return np.asarray(log_l(theta))
        out = np.empty(n, dtype=np.float64)
        for i in range(0, n, chunk):
            block = theta[i:i + chunk]
            m = block.shape[0]
            if m < chunk:
                block = np.concatenate(
                    [block, np.broadcast_to(block[:1],
                                            (chunk - m, theta.shape[1]))])
            out[i:i + m] = np.asarray(log_l(block))[:m]
        return out
    return wrapped


def flow_is_block(engine, prepared, log_l, seed: int,
                  n_samples: int = 3000) -> dict:
    """The flow-IS evidence on `prepared`: infer, then importance_correct
    on the marginalized likelihood."""
    from posteriflow_torch.inference.importance import importance_correct
    from posteriflow_torch.inference.pipeline import infer
    t0 = time.time()
    npe = infer(engine, data=prepared, n_samples=n_samples, seed=seed)
    ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
    res = importance_correct(engine, ctx[0], 0, npe.samples, npe.log_prob,
                             npe.railed, log_l, marginalized=True)
    return {"logz": float(res.log_evidence_ratio), "ess": float(res.ess),
            "efficiency": float(res.efficiency),
            "n_stages": int(res.n_stages),
            "t_s": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", default="model_release/npe_r7_best")
    ap.add_argument("--name", default="best")
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--anchors", default="analysis/anchors.json",
                    help="the anchors report holding asym_q's injection")
    ap.add_argument("--grid", type=int, nargs="*", default=None,
                    help="indices of GRID to run (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="analysis/anchor_convergence_torch.json")
    args = ap.parse_args(argv)

    import torch

    from posteriflow_torch.inference.dynesty_bridge import _nested_fallback
    from posteriflow_torch.inference.importance import \
        make_marginalized_log_likelihood
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    from posteriflow_torch.utils.logging import setup_logging
    from posteriflow_torch.utils.provenance import artifact_meta
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    log = setup_logging()
    injected = json.loads(Path(args.anchors).read_text())[
        "anchors"]["asym_q"]["injected"]
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    names = tuple(engine.cfg.param_names)
    prepared = prepare_simulated([injected], seed=args.seed,
                                 psd_bands=engine.cfg.psd_bands,
                                 param_names=names, device=args.device)
    log_l = make_marginalized_log_likelihood(prepared.strain,
                                             device=args.device)
    is_block = flow_is_block(engine, prepared, log_l, args.seed)
    log.info("flow-IS logZ %.2f (eff %.1f%%, %.0fs)", is_block["logz"],
             100 * is_block["efficiency"], is_block["t_s"])

    out_path = Path(args.out)
    report = {"case": "asym_q", "injected": injected, "seed": args.seed,
              "is": is_block, "runs": [],
              "_meta": artifact_meta(args.ckpt, device=args.device)}
    if out_path.exists():
        prev = json.loads(out_path.read_text())
        if prev.get("seed") == args.seed and prev.get("is"):
            report["runs"] = prev.get("runs", [])
    done = {(r["nlive"], r["walks"]) for r in report["runs"]}
    wrapped = _chunked(log_l)
    grid = [GRID[i] for i in args.grid] if args.grid is not None else GRID
    for nlive, walks, maxiter in grid:
        if (nlive, walks) in done:
            log.info("nlive=%d walks=%d: already done, skipping",
                     nlive, walks)
            continue
        t0 = time.time()
        ns = _nested_fallback(wrapped, nlive, dlogz=0.5, seed=args.seed,
                              maxiter=maxiter, walks=walks,
                              ndim=len(names))
        rec = {"nlive": nlive, "walks": walks, "logz": ns["logz"],
               "n_like_calls": ns["n_like_calls"],
               "gap_vs_is": is_block["logz"] - ns["logz"],
               "t_s": round(time.time() - t0, 1)}
        report["runs"].append(rec)
        log.info("nlive=%d walks=%d: logZ %.2f (gap %.2f, %.0fs)",
                 nlive, walks, rec["logz"], rec["gap_vs_is"], rec["t_s"])
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(report, indent=2, default=float))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2, default=float))
    print(json.dumps({"is_logz": is_block["logz"],
                      "runs": [(r["nlive"], r["walks"], round(r["logz"], 2),
                                round(r["gap_vs_is"], 2))
                               for r in report["runs"]]}, indent=1))
    return report


if __name__ == "__main__":
    main()
