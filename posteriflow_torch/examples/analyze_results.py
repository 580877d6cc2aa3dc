"""Results-analysis walkthrough: load a checkpoint, infer on a known
injection and tour the result object: the summary, the medians against
the truth, corner and marginal plots, the reconstruction overlay, the
uniform-mass reweighting and, with --importance, the importance
correction.

The port's twin of examples/analyze_results.py, on --device. The compute
(`analyze`) is split from the plots (`plot`, which needs matplotlib).

Run: python -m posteriflow_torch.examples.analyze_results --ckpt model_release/npe_r7_best \\
         [--out /tmp/results_tour] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

INJECTION = dict(mass_1=36.0, mass_2=29.0, luminosity_distance=400.0,
                 ra=1.0, dec=-0.5, theta_jn=0.5, psi=0.3, phase=1.0,
                 geocent_time=0.2, a1=0.1, a2=0.05)


def analyze(engine, n_samples: int = 2000, importance: bool = False,
            importance_kwargs=None, draws=None, z=None) -> dict:
    """The injection's prepared data, posterior and (with `importance`)
    its importance correction: {"prep", "result", "truth", "abs_error",
    "reweight_ess", "importance"}. The noise comes from seed 0, or from
    `draws` (a SimDraws of one event); the base draws from seed 0, or are
    `z` [1, n_samples, P]."""
    from posteriflow_torch.inference.pipeline import infer
    from posteriflow_torch.inference.preprocessing import prepare_simulated

    names = tuple(engine.cfg.param_names)
    prep = prepare_simulated([INJECTION], seed=0,
                             psd_bands=engine.cfg.psd_bands,
                             param_names=names, device=engine.device,
                             draws=draws)
    res = infer(engine, data=prep, n_samples=n_samples, seed=0, z=z)
    truth = np.array([INJECTION.get(k, 0.0) for k in names])
    _, ess = res.reweight_to_uniform_masses()
    out = {"prep": prep, "result": res, "truth": truth,
           "abs_error": np.abs(res.median() - truth),
           "reweight_ess": float(ess), "importance": None}
    if importance:
        from posteriflow_torch.inference.importance import (
            importance_correct, make_log_likelihood)
        ctx = engine.encode(prep.strain[None], prep.asd_bands[None])
        out["importance"] = importance_correct(
            engine, ctx[0], 0, res.samples, res.log_prob, res.railed,
            make_log_likelihood(prep.strain, device=engine.device),
            **(importance_kwargs or {}))
    return out


def plot(tour: dict, out: Path, device="cuda"):
    """corner.png, marginals.png and recon.png (matplotlib)."""
    from posteriflow_torch.inference.plots import reconstruction_overlay
    res = tour["result"]
    res.plot_corner(out / "corner.png")
    res.plot_marginals(out / "marginals.png")
    reconstruction_overlay(tour["prep"].strain, res.samples,
                           out / "recon.png", device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-samples", type=int, default=2000)
    ap.add_argument("--importance", action="store_true")
    ap.add_argument("--out", default="/tmp/results_tour")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.inference.pipeline import InferenceEngine

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    tour = analyze(engine, args.n_samples, args.importance)
    res = tour["result"]
    print(res.summary())
    print("\nper-parameter |median - truth|:")
    for n, err, t in zip(res.param_names, tour["abs_error"], tour["truth"]):
        print(f"  {n:>20s}: {err:10.4f} (truth {t:.3f})")
    plot(tour, out, args.device)
    res.save(out / "result")
    print(f"\nuniform-mass reweighting ESS: {tour['reweight_ess']:.1f} / "
          f"{len(res.samples)}")
    if tour["importance"] is not None:
        is_res = tour["importance"]
        print(f"importance: ESS {is_res.ess:.1f}, efficiency "
              f"{is_res.efficiency:.3f}, stages {is_res.n_stages}")
    print(f"\nartifacts -> {out}")
    return tour


if __name__ == "__main__":
    main()
