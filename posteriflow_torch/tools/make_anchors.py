"""Sampler-anchor evidence: NPE against importance-corrected NPE against
nested sampling on identical injections (the port's twin of
scripts/make_anchors.py).

For each injection of ANCHORS (the twin-grid corners, a razor-thin chirp
mass case and a loud GW150914-like one) on its own noise seed,
inference/dynesty_bridge.run_comparison runs the release's amortized
posterior, its importance correction and a flow-independent sampler (the
fallback nested sampler, or with --sampler smc_prior the tempered SMC from
the training prior) on the same phase/time-marginalized Whittle
likelihood, and the report records per-parameter KL, Wasserstein, JS and
median offsets between the three posteriors, their summaries, the IS block
and the evidence gap logZ_IS − logZ_sampler.

    python -m posteriflow_torch.tools.make_anchors \\
        [--ckpt model_release/npe_r7_best] [--only low_mc_razor] \\
        [--nlive 400] [--maxiter 12000] [--n-samples 3000] \\
        [--sampler nested|smc_prior] [--device cuda] \\
        [--out analysis/anchors_torch.json]
    python -m posteriflow_torch.tools.make_anchors \\
        --self-check gw150914_like --out /tmp/self_check.json

The report resumes: the anchors already in --out are kept, and an --out
written from a checkpoint of another config hash is refused. --self-check
NAME runs the nested sampler twice (seeds 11 and 1011) on that anchor's
injection and records their mutual agreement instead. Everything runs on
--device; the default --ckpt is the release behind analysis/anchors.json
(config hash b58b05b3ce29).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
import zlib
from pathlib import Path

import numpy as np

# the twin-grid corners (Mc low/high × q near-equal/asymmetric), the
# razor-thin-Mc case (gw170608-like) and a loud GW150914-like anchor;
# distances for SNR ~15-25
ANCHORS = [
    dict(name="gw150914_like", mass_1=36.0, mass_2=29.0,
         luminosity_distance=700.0),
    dict(name="low_mc_razor", mass_1=11.0, mass_2=7.6,
         luminosity_distance=450.0),
    dict(name="high_mc", mass_1=60.0, mass_2=45.0,
         luminosity_distance=1500.0),
    dict(name="asym_q", mass_1=30.1, mass_2=8.3,
         luminosity_distance=600.0),
    dict(name="q_attractor", mass_1=25.0, mass_2=15.0,
         luminosity_distance=800.0),
]
_BASE = dict(ra=1.7, dec=-0.8, theta_jn=0.9, psi=0.6, phase=2.1,
             geocent_time=0.1, a1=0.2, a2=0.1)
SELF_CHECK_SEEDS = (11, 1011)

log = logging.getLogger("posteriflow.anchors")


def _seed_of(name: str) -> int:
    """Deterministic per-anchor seed (process-independent, unlike hash())."""
    return zlib.crc32(name.encode()) % 2 ** 16


def _injection_params(spec: dict, names) -> dict:
    """Anchor spec -> full injection dict (the precessing block appended for
    15-D checkpoints, drawn from default_rng(_seed_of(name)))."""
    params = {k: v for k, v in spec.items() if k != "name"}
    params.update(_BASE)
    if len(names) >= 15:
        rng_a = np.random.default_rng(_seed_of(spec["name"]))
        params.update(
            a1=0.5, a2=0.2,
            tilt_1=float(np.arccos(rng_a.uniform(-1, 1))),
            tilt_2=float(np.arccos(rng_a.uniform(-1, 1))),
            phi_12=float(rng_a.uniform(0, 2 * np.pi)),
            phi_jl=float(rng_a.uniform(0, 2 * np.pi)))
    return params


def _prepare(engine, spec: dict):
    from posteriflow_torch.inference.preprocessing import prepare_simulated
    names = tuple(engine.cfg.param_names)
    params = _injection_params(spec, names)
    return params, prepare_simulated([params], seed=_seed_of(spec["name"]),
                                     psd_bands=engine.cfg.psd_bands,
                                     param_names=names,
                                     device=engine.device)


def _self_check(engine, prepared, nlive: int, maxiter: int,
                seeds=SELF_CHECK_SEEDS, n_keep: int = 3000) -> dict:
    """Two independent nested runs on the SAME data: their logZ gap and
    the agreement of their posteriors (the sampler's own scatter)."""
    from posteriflow_torch.evaluation.metrics import ComparisonMetrics
    from posteriflow_torch.inference.dynesty_bridge import run_dynesty
    from posteriflow_torch.inference.importance import \
        make_marginalized_log_likelihood

    log_l = make_marginalized_log_likelihood(prepared.strain,
                                             device=engine.device)
    runs, kept = [], []
    for s in seeds:
        t0 = time.time()
        r = run_dynesty(log_l, nlive=nlive, seed=s, maxiter=maxiter,
                        ndim=engine.cfg.n_params)
        idx = np.random.default_rng(s).choice(
            len(r["samples"]), size=min(n_keep, len(r["samples"])),
            p=r["weights"])
        kept.append(r["samples"][idx])
        runs.append({"seed": s, "logz": float(r["logz"]),
                     "n_like_calls": int(r.get("n_like_calls", -1)),
                     "wall_s": round(time.time() - t0, 1)})
    comp = ComparisonMetrics().compare_posteriors(
        kept[0], kept[1], param_names=tuple(engine.cfg.param_names))
    comp.pop("phase", None)
    comp.pop("geocent_time", None)
    return {"nlive": nlive, "runs": runs,
            "logz_gap_run0_minus_run1": runs[0]["logz"] - runs[1]["logz"],
            "summary": ComparisonMetrics.summarize(comp),
            "per_param": comp}


def anchor_entry(engine, spec: dict, n_samples: int, nlive: int,
                 maxiter: int, sampler: str = "nested") -> dict:
    """One anchor's report entry (every field of the JAX script's)."""
    from posteriflow_torch.evaluation.metrics import ComparisonMetrics
    from posteriflow_torch.inference.dynesty_bridge import run_comparison
    params, prepared = _prepare(engine, spec)
    t0 = time.time()
    cmp = run_comparison(engine, prepared, n_samples=n_samples, nlive=nlive,
                         maxiter=maxiter, importance=True, sampler=sampler)
    return {
        "injected": params,
        "sampler_marginalized": True,
        "summary_npe": ComparisonMetrics.summarize(cmp["comparison"]),
        "summary_is": ComparisonMetrics.summarize(cmp["is_comparison"]),
        "comparison_npe_vs_sampler": cmp["comparison"],
        "comparison_is_vs_sampler": cmp["is_comparison"],
        "is": cmp["is"],
        "logz_gap_is_minus_sampler": cmp["logz_gap"],
        "sampler": {k: cmp["nested"][k] for k in
                    ("logz", "sampler", "n_like_calls")},
        "t_npe_s": round(cmp["t_npe_s"], 2),
        "t_nested_s": round(cmp["t_nested_s"], 2),
        "t_total_s": round(time.time() - t0, 1),
        "param_names": list(engine.cfg.param_names),
    }


def start_report(out_path: Path, ckpt, n_samples: int, nlive: int,
                 sampler: str) -> dict:
    """A fresh report, with the finished anchors of `out_path` kept when it
    comes from the same config hash; SystemExit when it does not."""
    from posteriflow_torch.utils.provenance import artifact_meta
    report = {"ckpt": str(ckpt), "n_samples": n_samples, "nlive": nlive,
              "sampler": sampler, "anchors": {},
              "_meta": artifact_meta(ckpt)}
    if out_path.exists():
        prev = json.loads(out_path.read_text())
        prev_hash = (prev.get("_meta") or {}).get("config_hash")
        if prev_hash and prev_hash != report["_meta"].get("config_hash"):
            raise SystemExit(
                f"{out_path} was generated from config_hash {prev_hash}, "
                f"current --ckpt hashes {report['_meta'].get('config_hash')}"
                f": refusing to mix anchors across models (delete the file "
                f"or pass a matching --ckpt)")
        report["anchors"] = prev.get("anchors", {})
    return report


def _write(out_path: Path, report: dict):
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2, default=float))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", default="model_release/npe_r7_best",
                    help="a release directory, or a CheckpointManager root")
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-samples", type=int, default=3000)
    ap.add_argument("--nlive", type=int, default=400)
    ap.add_argument("--maxiter", type=int, default=12000)
    ap.add_argument("--sampler", choices=("nested", "smc_prior"),
                    default="nested",
                    help="smc_prior = flow-independent tempered SMC from "
                         "the training prior (an evidence in the same "
                         "convention as IS)")
    ap.add_argument("--only", help="comma list of anchor names")
    ap.add_argument("--self-check", metavar="NAME",
                    help="instead of anchoring: run the nested sampler "
                         "twice (independent seeds) on this anchor's "
                         "injection and record their mutual agreement")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="analysis/anchors_torch.json")
    args = ap.parse_args(argv)

    import torch

    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.utils.logging import setup_logging
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    setup_logging()
    out_path = Path(args.out)
    report = start_report(out_path, args.ckpt, args.n_samples, args.nlive,
                          args.sampler)
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    if args.self_check:
        spec = next(s for s in ANCHORS if s["name"] == args.self_check)
        params, prepared = _prepare(engine, spec)
        sc = _self_check(engine, prepared, args.nlive, args.maxiter)
        sc["case"] = spec["name"]
        sc["injected"] = params
        report["sampler_self_consistency"] = sc
        _write(out_path, report)
        print(json.dumps({"case": sc["case"],
                          "logz_gap": sc["logz_gap_run0_minus_run1"],
                          "mean_width_ratio":
                              sc["summary"]["mean_width_ratio"],
                          "mean_js": sc["summary"]["mean_js"]}, indent=2))
        return report

    sel = set(args.only.split(",")) if args.only else None
    for spec in ANCHORS:
        name = spec["name"]
        if sel and name not in sel:
            continue
        if name in report["anchors"]:
            log.info("%s: already done, skipping", name)
            continue
        entry = anchor_entry(engine, spec, args.n_samples, args.nlive,
                             args.maxiter, args.sampler)
        report["anchors"][name] = entry
        _write(out_path, report)
        log.info("%s done in %.0fs: logz_gap %.2f", name,
                 entry["t_total_s"], entry["logz_gap_is_minus_sampler"])

    print(json.dumps({k: {"logz_gap": v["logz_gap_is_minus_sampler"],
                          "t_total_s": v["t_total_s"]}
                      for k, v in report["anchors"].items()}, indent=2))
    return report


if __name__ == "__main__":
    main()
