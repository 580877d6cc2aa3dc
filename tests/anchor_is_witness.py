"""Why an anchor's importance correction can end on a collapsed cloud: the
port's run and the JAX package's own importance_correct on the same entry
cloud.

Two steps:

    python tests/anchor_is_witness.py dump --out results/anchor_is.npz \\
        [--anchor low_mc_razor] [--seeds 0 1 2 3] [--device cuda]
    python tests/anchor_is_witness.py witness results/anchor_is.npz \\
        [--seeds 0 1 2 3] [--nested] [--out results/anchor_is_witness.json]

`dump` (the port alone, on --device) prepares the anchor as
tools/make_anchors.py does, draws its 3000 NPE samples as run_comparison
does (infer at seed 0), runs the port's importance_correct on them at each
seed and writes the entry cloud's inputs (whitened strain, ASD bands,
draws, log q, railed) with each run's record. `witness` (the JAX package on
the CPU) reads that file, builds JAX's engine from the same release and
JAX's marginalized likelihood on the same strain, and runs JAX's
importance_correct on the same draws at each seed. Both record per run:
the ladder, the Metropolis acceptance a stage, ESS, log Z, the number of
distinct particles and the weight of the heaviest one (a cloud whose
heaviest particle holds ~all the weight has a 5-95% width of 0); and for
the entry cloud the spread of log(L·π/g0), whose largest values decide
which particle the final hop hands the weight to. With --nested the
witness also runs JAX's nested sampler as run_comparison does (seed 0,
nlive 400, maxiter 12000) on the same strain and compares the NPE draws
with its posterior as make_anchors does.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
RELEASE = str(ROOT / "model_release" / "npe_r7_best")
N_SAMPLES = 3000


def cloud_record(res) -> dict:
    """An ISResult -> the figures both packages' runs are compared on."""
    w = np.asarray(res.weights, np.float64)
    w = w / w.sum()
    _, inv = np.unique(np.asarray(res.samples), axis=0, return_inverse=True)
    mass = np.bincount(inv.ravel(), weights=w)
    return {"n_stages": int(res.n_stages), "ladder": list(res.beta_ladder
                                                          or []),
            "acceptance": [float(a) for a in (res.mcmc_acceptance or [])],
            "ess": float(res.ess), "logz": float(res.log_evidence_ratio),
            "distinct": int(mass.size), "heaviest": float(mass.max())}


def entry_record(ll, lp, lq) -> dict:
    """log(L·π/g0) of the entry cloud (g0 the flow's density as the IS
    uses it, before the t_c correction): its top values and percentiles."""
    delta = np.sort(np.asarray(ll, np.float64) + lp - lq)
    return {"top5": delta[-5:][::-1].tolist(),
            "p50_p90_p99": np.percentile(delta, [50, 90, 99]).tolist()}


def dump(args):
    import torch

    from posteriflow_torch.inference.importance import (
        host_log_prior, importance_correct,
        make_marginalized_log_likelihood, symmetrized_log_q)
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.tools import make_anchors
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    engine = InferenceEngine.from_checkpoint(RELEASE, device=args.device)
    spec = next(s for s in make_anchors.ANCHORS if s["name"] == args.anchor)
    _, prepared = make_anchors._prepare(engine, spec)
    npe = infer(engine, data=prepared, n_samples=N_SAMPLES, seed=0)
    ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
    log_l = make_marginalized_log_likelihood(prepared.strain,
                                             device=args.device)
    keep = ~np.asarray(npe.railed)
    th = npe.samples[keep].astype(np.float32)
    entry = entry_record(
        log_l(th), host_log_prior(device=args.device)(th),
        symmetrized_log_q(engine, ctx[0], 0, th).cpu().numpy())
    runs = {}
    for seed in args.seeds:
        res = importance_correct(engine, ctx[0], 0, npe.samples,
                                 npe.log_prob, npe.railed, log_l,
                                 marginalized=True, seed=seed)
        runs[str(seed)] = cloud_record(res)
        print(seed, json.dumps(runs[str(seed)]), flush=True)
    record = {"anchor": args.anchor, "device": str(engine.device),
              "kind": (torch.cuda.get_device_name(0)
                       if engine.device.type == "cuda" else "cpu"),
              "entry": entry, "runs": runs}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, strain=np.asarray(prepared.strain),
                        asd_bands=np.asarray(prepared.asd_bands),
                        samples=npe.samples, log_prob=npe.log_prob,
                        railed=npe.railed, record=json.dumps(record))
    print(json.dumps(record, indent=1))


def nested_record(log_l, npe_samples) -> dict:
    """JAX's nested sampler at the anchors' settings on log_l, and the NPE
    draws against its posterior as make_anchors summarizes them."""
    from posteriflow_tpu import PARAM_NAMES_PRECESSING
    from posteriflow_tpu.evaluation.metrics import ComparisonMetrics
    from posteriflow_tpu.inference.dynesty_bridge import run_dynesty
    ns = run_dynesty(log_l, nlive=400, seed=0, maxiter=12000, ndim=15)
    idx = np.random.default_rng(0).choice(
        len(ns["samples"]), size=min(N_SAMPLES, len(ns["samples"])),
        p=ns["weights"])
    comp = ComparisonMetrics().compare_posteriors(
        npe_samples, ns["samples"][idx], param_names=PARAM_NAMES_PRECESSING)
    comp.pop("phase", None)
    comp.pop("geocent_time", None)
    return {"logz": float(ns["logz"]), "n_like_calls": ns["n_like_calls"],
            "n_stuck_chains": ns.get("n_stuck_chains"),
            "summary_npe": ComparisonMetrics.summarize(comp),
            "width_ratio_npe": {k: v["width_ratio"] for k, v in comp.items()}}


def witness(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from posteriflow_tpu.inference.importance import (
        importance_correct, make_marginalized_log_likelihood,
        symmetrized_log_q)
    from posteriflow_tpu.inference.pipeline import InferenceEngine
    from posteriflow_tpu.prior import log_prior_bbh
    d = np.load(args.dump)
    port = json.loads(str(d["record"]))
    engine = InferenceEngine.from_checkpoint(RELEASE)
    ctx = engine.encode(d["strain"][None], d["asd_bands"][None])
    log_l = make_marginalized_log_likelihood(d["strain"])
    keep = ~np.asarray(d["railed"])
    th = d["samples"][keep].astype(np.float32)
    ll = np.concatenate([np.asarray(log_l(th[i:i + 512]))
                         for i in range(0, len(th), 512)])
    lp = np.asarray(jax.vmap(log_prior_bbh)(th))
    lq = np.asarray(symmetrized_log_q(engine, ctx[0], 0,
                                      jax.numpy.asarray(th)))
    out = {"anchor": port["anchor"], "port": port,
           "jax": {"entry": entry_record(ll, lp, lq), "runs": {}}}
    print("entry, port:", port["entry"], "\nentry, JAX:",
          out["jax"]["entry"], flush=True)
    if args.nested:
        out["jax"]["nested"] = nested_record(log_l, d["samples"])
        print("nested, JAX:", out["jax"]["nested"], flush=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    for seed in args.seeds:
        res = importance_correct(engine, ctx[0], 0, d["samples"],
                                 d["log_prob"], d["railed"], log_l,
                                 marginalized=True, seed=seed)
        out["jax"]["runs"][str(seed)] = cloud_record(res)
        print(f"seed {seed}: port {port['runs'].get(str(seed))}\n"
              f"        JAX  {out['jax']['runs'][str(seed)]}", flush=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="step", required=True)
    a = sub.add_parser("dump")
    a.add_argument("--out", default="results/anchor_is.npz")
    a.add_argument("--anchor", default="low_mc_razor")
    a.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    a.add_argument("--device", default="cuda")
    b = sub.add_parser("witness")
    b.add_argument("dump")
    b.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    b.add_argument("--nested", action="store_true",
                   help="also JAX's nested sampler on the same strain")
    b.add_argument("--out", default="results/anchor_is_witness.json")
    args = ap.parse_args(argv)
    return dump(args) if args.step == "dump" else witness(args)


if __name__ == "__main__":
    main()
