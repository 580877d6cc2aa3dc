"""Amortized inference from the command line, with the importance
correction and overlap ranking (the port's twin of the repository's
infer.py, for the paths the port serves).

    python -m posteriflow_torch.tools.infer --ckpt model_release/npe_r7_best \\
        --inject --n-samples 5000 --importance --out results/inj
    python -m posteriflow_torch.tools.infer --ckpt model_release/npe_r7_best \\
        --strain strain.npy --gps 1369224018 --out results/ev
    python -m posteriflow_torch.tools.infer --ckpt RELEASE --inject \\
        --device cpu --n-samples 64 --out /tmp/inj
    python -m posteriflow_torch.tools.infer --ckpt model_release/npe_r7_best \\
        --inject --n-signals 3 --out results/overlap
    python -m posteriflow_torch.tools.infer --ckpt model_release/npe_r7_best \\
        --event GW150914 --out results/gw150914

Sources: --event (open strain around a catalog event, fetched from GWOSC
with gwpy: without gwpy this raises fetch_gwosc's ImportError), --strain (one .npy [3, T] or one file per detector, named
H1_*.npy, L1_*.npy, V1_*.npy) with --gps and optionally --asd; or --inject,
a fresh injection through the simulator, at --inject-params (a JSON list
of parameter dicts, or a file holding one) or at --n-signals draws from
the checkpoint's own prior (15-D releases get precessing draws) from a
torch.Generator seeded with --seed. --importance corrects the draws
against the phase/time-marginalized Whittle likelihood and saves the
normalized weights beside the samples (weights.npy). --n-signals > 1
infers one posterior per rank (saved as rank0, rank1, ...), orders them
with the released PriorityNet (or the loudness fallback when none is
present) and writes ranking.json with the order and the scores.
--plots (needs matplotlib) draws corner.png and marginals.png beside the
samples, or rank{r}/corner.png for each rank of --n-signals > 1.
Everything runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="release directory, or a checkpoint root")
    ap.add_argument("--name", default="best",
                    help="checkpoint name under a checkpoint root")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--event", help="GWOSC event name (needs gwpy)")
    src.add_argument("--strain", nargs="+",
                     help="strain file(s): one .npy [3,T] or H1/L1/V1 files")
    src.add_argument("--inject", action="store_true",
                     help="fresh simulated injection")
    ap.add_argument("--gps", type=float, help="GPS time for --strain")
    ap.add_argument("--asd", nargs="+",
                    help="measured ASD/PSD txt file(s), 'DET:path' or one "
                         "per detector in H1 L1 V1 order")
    ap.add_argument("--inject-params",
                    help="JSON file/string: list of parameter dicts")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--n-signals", type=int, default=1)
    ap.add_argument("--n-samples", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--importance", action="store_true",
                    help="importance-correct against the exact likelihood")
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--out", default="results/run")
    ap.add_argument("--device", default="cuda")
    return ap


def _asd_override(specs):
    from posteriflow_torch.physics.psd import load_asd_file
    dets = ("H1", "L1", "V1")
    out = {}
    for i, spec in enumerate(specs):
        det, _, path = (spec.rpartition(":") if ":" in spec
                        else (dets[i], ":", spec))
        out[det] = load_asd_file(path)
    return out


def _injection(args, engine):
    """The injection's parameter dicts: --inject-params, or --n-signals
    draws from the checkpoint's prior."""
    if args.inject_params:
        raw = args.inject_params
        txt = Path(raw).read_text() if Path(raw).exists() else raw
        return json.loads(txt)
    import torch

    from posteriflow_torch.prior import PriorConfig, sample_signal_params
    names = tuple(engine.cfg.param_names)
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    draws = sample_signal_params((args.n_signals,),
                                 PriorConfig(precessing=len(names) >= 15),
                                 generator=gen, device=engine.device)
    return [dict(zip(names, map(float, d))) for d in draws.cpu().numpy()]


def _overlapping(args, engine, prepared):
    """One posterior per rank, their extraction order, saved as rank{r}/
    and ranking.json."""
    from posteriflow_torch.inference.pipeline import infer_overlapping
    from posteriflow_torch.inference.ranking import rank_overlapping
    results = infer_overlapping(engine, data=prepared,
                                n_signals=args.n_signals,
                                n_samples=args.n_samples, seed=args.seed)
    order, scores = rank_overlapping(results, prepared.strain,
                                     device=engine.device)
    print(f"extraction order: {order} (scores "
          f"{[round(s, 4) for s in scores]})")
    out = Path(args.out)
    for r, res in enumerate(results):
        print(res.summary())
        res.save(out / f"rank{r}")
        if args.plots:
            res.plot_corner(out / f"rank{r}" / "corner.png")
    (out / "ranking.json").write_text(json.dumps({"order": order,
                                                  "scores": scores}))
    print(f"saved -> {out}")
    return results


def main(argv=None):
    args = _parser().parse_args(argv)

    from posteriflow_torch.inference.importance import (
        importance_correct, make_marginalized_log_likelihood)
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.inference.preprocessing import (fetch_gwosc,
                                                           prepare_real,
                                                           prepare_simulated)

    fetched = None
    if args.event:
        # the fetch first: without gwpy it fails before a model is loaded
        fetched = fetch_gwosc(event=args.event)
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    asd_by_det = _asd_override(args.asd) if args.asd else None
    if fetched is not None:
        strain_by_det, gps = fetched
        prepared = prepare_real(strain_by_det, gps_time=gps,
                                psd_bands=engine.cfg.psd_bands,
                                asd_by_det=asd_by_det)
    elif args.inject:
        params_list = _injection(args, engine)
        print("injected params:", json.dumps(params_list))
        prepared = prepare_simulated(params_list, seed=args.seed,
                                     psd_bands=engine.cfg.psd_bands,
                                     param_names=tuple(engine.cfg.param_names),
                                     device=engine.device)
    else:
        files = args.strain
        if len(files) == 1:
            arr = np.load(files[0])
            strain_by_det = {d: arr[i] for i, d in
                             enumerate(("H1", "L1", "V1"))}
        else:
            strain_by_det = {Path(f).stem.split("_")[0]: np.load(f)
                             for f in files}
        prepared = prepare_real(
            strain_by_det, gps_time=args.gps or 0.0,
            psd_bands=engine.cfg.psd_bands, asd_by_det=asd_by_det)

    if args.n_signals > 1:
        return _overlapping(args, engine, prepared)

    res = infer(engine, data=prepared, rank=args.rank,
                n_samples=args.n_samples, seed=args.seed)
    if args.importance:
        ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
        is_res = importance_correct(
            engine, ctx[0], args.rank, res.samples, res.log_prob,
            res.railed, make_marginalized_log_likelihood(
                prepared.strain, device=engine.device),
            marginalized=True, seed=args.seed)
        print(f"IS: ESS {is_res.ess:.1f} / {len(is_res.samples)} "
              f"(efficiency {is_res.efficiency:.3f}, stages "
              f"{is_res.n_stages}, converged {is_res.converged})")
        res.weights = is_res.weights
        res.samples = is_res.samples
        res.log_prob = None
        res.railed = None
        res.diagnostics["importance"] = {
            "ess": is_res.ess, "efficiency": is_res.efficiency,
            "n_stages": is_res.n_stages, "converged": is_res.converged,
            "beta_ladder": is_res.beta_ladder,
            "mcmc_acceptance": is_res.mcmc_acceptance,
            "log_evidence_ratio": is_res.log_evidence_ratio,
            **is_res.diagnostics}
    print(res.summary())
    res.save(args.out)
    if args.plots:
        res.plot_corner(Path(args.out) / "corner.png")
        res.plot_marginals(Path(args.out) / "marginals.png")
    print(f"saved -> {args.out}")
    return res


if __name__ == "__main__":
    main()
