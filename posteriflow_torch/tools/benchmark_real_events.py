"""NPE against nested sampling on catalog-like events: the same data,
priors and conventions; per-parameter comparison metrics and wall times.

The port's twin of scripts/benchmark_real_events.py, in its injection
mode: each event of --events is injected with its catalog masses and
distance (capped at 2100 Mpc) and fixed extrinsics, with noise seeded by
hash(name) % 2**16 as the JAX script seeds it (Python salts string hashes
per process unless PYTHONHASHSEED is set, so the noise differs from run
to run, in both packages), then run_comparison (the NPE through `infer`,
the nested sampler on the phase/time-marginalized likelihood) on
--device. --fetch takes real strain through gwpy and the network, which
this tool does not reach: it raises gwpy's ImportError where gwpy is
missing, as JAX's does.

Usage:
  python -m posteriflow_torch.tools.benchmark_real_events --ckpt DIR \\
      [--events GW150914 GW170814] [--out results/real_event_benchmark]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--events", nargs="+",
                    default=["GW150914", "GW170104", "GW170814"])
    ap.add_argument("--n-samples", type=int, default=2000)
    ap.add_argument("--nlive", type=int, default=200)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--fetch", action="store_true",
                    help="fetch real strain via gwpy instead of injecting")
    ap.add_argument("--out", default="results/real_event_benchmark")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    from posteriflow_torch.data.gwtc import GWTCLoader
    from posteriflow_torch.inference.dynesty_bridge import run_comparison
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.inference.preprocessing import (prepare_real,
                                                           prepare_simulated)

    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=args.device)
    gl = GWTCLoader()
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    summary = {}
    for name in args.events:
        ev = gl.get_event(name)
        if args.fetch:
            from posteriflow_torch.inference.preprocessing import fetch_gwosc
            strain, gps = fetch_gwosc(event=name)
            prep = prepare_real(strain, gps_time=gps,
                                psd_bands=engine.cfg.psd_bands)
        else:
            inj = dict(mass_1=ev["mass_1"], mass_2=ev["mass_2"],
                       luminosity_distance=min(ev["luminosity_distance"],
                                               2100.0),
                       ra=1.5, dec=-0.3, theta_jn=0.6, psi=0.4, phase=1.2,
                       geocent_time=0.0, a1=0.0, a2=0.0)
            prep = prepare_simulated([inj], seed=hash(name) % 2 ** 16,
                                     psd_bands=engine.cfg.psd_bands,
                                     param_names=engine.cfg.param_names,
                                     device=engine.device)
        cmp_out = run_comparison(engine, prep, n_samples=args.n_samples,
                                 nlive=args.nlive, maxiter=args.maxiter)
        rec = {
            "event": name,
            "t_npe_s": cmp_out["t_npe_s"],
            "t_nested_s": cmp_out["t_nested_s"],
            "speedup": cmp_out["speedup"],
            "nested_sampler": cmp_out["nested"]["sampler"],
            "verdict": cmp_out["npe"].verdict,
            "comparison": {k: v for k, v in cmp_out["comparison"].items()
                           if k in ("mass_1", "mass_2",
                                    "luminosity_distance",
                                    "geocent_time")},
        }
        summary[name] = rec
        cmp_out["npe"].save(outdir / name)
        log.info("%s: NPE %.2fs vs %s %.1fs (%.0fx)", name,
                 rec["t_npe_s"], rec["nested_sampler"], rec["t_nested_s"],
                 rec["speedup"])

    (outdir / "summary.json").write_text(json.dumps(summary, indent=2,
                                                    default=float))
    return summary


if __name__ == "__main__":
    main()
