"""Checkpoint-level CI gate suite -> JSON + HTML report + exit code.

The port's twin of scripts/validate_checkpoint.py. On fixed seeded
validation events, in chunks of 256 (rounded up, as JAX does):

  - context-shuffle ΔNLL > 5 nats
  - 50%/90% coverage within ±0.07/±0.05 (≤2 parameters excepted)
  - SBC KS p > 1e-3 for ≥ 9/11 of the parameters
  - spurious railing < 5%
  - distance correlation (log median vs truth) > 0.5
  - injected smoke tests: |t_c| error < 0.1 s on loud reference-like events
  - the live OOD battery (glitch-only, out-of-prior masses, mis-whitened
    strain) flagged, and glitch+signal events handled
  - with --noise-bank: a deterministic real-noise validation domain and
    the real-vs-Gaussian NLL gap < 3 nats gate

plus OOD-stat fitting: `<ckpt>/ood_stats.npz`, which arms inference's OOD
verdict (InferenceEngine.from_checkpoint loads it), and this run's engine.

The random draws of chunk i come from a torch.Generator seeded with
seed·1_000_003 + i (seed + 77 for the real-noise domain), as JAX folds its
key; the streams are not JAX's, so the figures agree with a JAX report
statistically, not bit for bit. Everything runs on --device (default
cuda).

Usage: python -m posteriflow_torch.tools.validate_checkpoint --ckpt DIR \\
           [--noise-bank banks/dir] [--n-events 2000] [--n-post 400] \\
           [--device cpu] [--out DIR]

The report goes to --out, by default <ckpt>/../validation as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    "smoke_tc_max_abs_err": ("<", 0.1),
    # live OOD battery: every genuinely-OOD input (glitch-only,
    # out-of-prior masses, mis-whitened strain) must be flagged
    # (verdict != HIGH or refine fired)
    "ood_flag_frac": (">=", 1.0),
    # glitch+SIGNAL robustness: a loud injection contaminated by a burst
    # glitch must either stay accurate (|t_c| < 0.1 s, Mc within 20%) or
    # be flagged
    "glitch_signal_handled_frac": (">=", 1.0),
}

# the gate armed when a noise bank provides the real-noise domain
REAL_GATE = {"real_gaussian_nll_gap": ("<", 3.0)}

CHUNK = 256

SMOKE_PARAMS = [
    dict(mass_1=36.0, mass_2=29.0, luminosity_distance=400.0),   # GW150914-like
    dict(mass_1=31.0, mass_2=20.0, luminosity_distance=660.0),   # GW170104-like
    dict(mass_1=12.0, mass_2=7.0, luminosity_distance=340.0),    # GW151226-like
    dict(mass_1=51.0, mass_2=34.0, luminosity_distance=2700.0),  # GW170729-like (OOD-distance)
    dict(mass_1=35.0, mass_2=27.0, luminosity_distance=540.0),   # GW170814-like
    dict(mass_1=23.0, mass_2=13.0, luminosity_distance=320.0),   # GW170608-like
]


def _check(name, value, spec):
    op, thresh = spec
    ok = {"<": value < thresh, "<=": value <= thresh,
          ">": value > thresh, ">=": value >= thresh}[op]
    return {"gate": name, "value": float(value), "op": op,
            "threshold": thresh, "passed": bool(ok)}


def chunk_metrics(diag_fn, cal_fn, model, batch, generator=None, perm=None,
                  z_diag=None, z_cal=None) -> dict:
    """One validation chunk: the diagnostics' scalars and cov50, the
    calibration metrics' cov90, railing, base_conc, SBC ranks and live
    mask, as floats and numpy arrays. The permutation and the base draws
    come from `generator` unless given."""
    d = diag_fn(model, batch, generator=generator, perm=perm, z=z_diag)
    cal = cal_fn(model, batch, generator=generator, z=z_cal)
    return {"diag": {k: v for k, v in d.items() if isinstance(v, float)},
            "cov50": d["cov50_all"],
            "cov90": cal["cov90_all"].cpu().numpy(),
            "spurious_railing": float(cal["spurious_railing"]),
            "base_conc": float(cal["base_conc"]),
            "ranks": cal["sbc_ranks"].cpu().numpy(),
            "live": cal["live_mask"].cpu().numpy()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--n-events", type=int, default=2000)
    ap.add_argument("--n-post", type=int, default=400)
    ap.add_argument("--n-smoke", type=int, default=6)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--noise-bank", default=None,
                    help="bank dir: adds the deterministic real-noise "
                         "domain + the real-vs-Gaussian gap gate")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def run(argv=None):
    """main's body -> (exit code, report, record). The record holds what
    the report averages away: each Gaussian chunk's scalars and the
    seconds of each part of the run."""
    args = _parser().parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import torch

    from posteriflow_torch.inference.ood import fit_context_stats
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import load_checkpoint_model
    from posteriflow_torch.train.diagnostics import make_diagnostics
    from posteriflow_torch.train.gates import (make_calibration_metrics,
                                               sbc_pass_frac)

    t_start = time.time()
    device = torch.device(args.device)
    state_dict, cfg, meta = load_checkpoint_model(args.ckpt, args.name)
    PARAM_NAMES = tuple(cfg.npe.param_names)   # checkpoint's own set
    engine = InferenceEngine(state_dict, cfg.npe, device=device)
    model = engine.model
    log.info("checkpoint %s/%s (epoch %s) on %s", args.ckpt, args.name,
             meta.get("epoch"), device)

    # fixed seeded validation batch (Gaussian domain), evaluated in chunks;
    # rounded UP so the effective count covers the nominal request (the
    # report records both)
    n_chunks = max(1, -(-args.n_events // CHUNK))
    diag_fn = make_diagnostics(cfg, n_events=CHUNK, n_post=args.n_post)
    cal_fn = make_calibration_metrics(cfg, n_events=CHUNK,
                                      n_post=args.n_post)

    def generator(seed, i):
        """Chunk i's draws (JAX: fold_in(PRNGKey(seed), i))."""
        return torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + i)

    chunks, contexts = [], []
    for i in range(n_chunks):
        gen = generator(args.seed, i)
        batch = simulate_batch(CHUNK, cfg.sim, device=device, generator=gen)
        chunks.append(chunk_metrics(diag_fn, cal_fn, model, batch,
                                    generator=gen))
        contexts.append(engine.encode(batch.strain, batch.asd_bands)
                        .float().cpu().numpy())
    t_chunks = time.time()

    def avg(key_):
        return float(np.mean([c["diag"][key_] for c in chunks]))

    # deterministic real-noise validation domain (same seeds + 77, every
    # event on a real crop)
    real_metrics = {}
    if args.noise_bank:
        from posteriflow_torch.data.noise_bank import load_noise_bank
        bank = load_noise_bank(args.noise_bank,
                               psd_bands=cfg.sim.psd_bands, device=device)
        real_cfg = dataclasses.replace(cfg.sim, real_noise_prob=1.0)
        rdiags = []
        for i in range(n_chunks):
            gen = generator(args.seed + 77, i)
            batch = simulate_batch(CHUNK, real_cfg, device=device,
                                   generator=gen, bank=bank)
            d = diag_fn(model, batch, generator=gen)
            rdiags.append({k: v for k, v in d.items()
                           if isinstance(v, float)})
        real_metrics = {
            "real_val_nll": float(np.mean([d["val_nll_diag"]
                                           for d in rdiags])),
            "real_dist_corr": float(np.mean([d["dist_corr"]
                                             for d in rdiags])),
            "real_shuffle_delta_nll": float(np.mean(
                [d["shuffle_delta_nll"] for d in rdiags])),
        }
    t_real = time.time()

    cov50 = np.mean(np.stack([c["cov50"] for c in chunks]), axis=0)
    cov90 = np.mean(np.stack([c["cov90"] for c in chunks]), axis=0)
    cov50_viol = int(np.sum(np.abs(cov50 - 0.50) > 0.07))
    cov90_viol = int(np.sum(np.abs(cov90 - 0.90) > 0.05))

    frac, ps = sbc_pass_frac(np.concatenate([c["ranks"] for c in chunks]),
                             np.concatenate([c["live"] for c in chunks]),
                             args.n_post)
    railing = float(np.mean([c["spurious_railing"] for c in chunks]))

    # OOD stats: fit + persist (arms inference), and arm THIS run's engine
    # so the smoke/OOD batteries exercise the live verdict path
    stats = fit_context_stats(np.concatenate(contexts))
    stats.save(Path(args.ckpt) / "ood_stats.npz")
    engine.ood_stats = stats
    t_ood = time.time()

    # injected smoke battery: loud reference-like events through infer()
    smoke = []
    smoke_params = SMOKE_PARAMS[: args.n_smoke]
    tc_errs = []
    for i, p in enumerate(smoke_params):
        full = {"ra": 1.0 + i, "dec": 0.3 - 0.1 * i, "theta_jn": 0.5,
                "psi": 0.4, "phase": 1.0, "geocent_time": 0.1, "a1": 0.1,
                "a2": 0.05, **p}
        res = infer(engine, inject=[full], n_samples=512, seed=100 + i)
        tc_err = abs(float(res.median()[8]) - full["geocent_time"])
        tc_errs.append(tc_err)
        smoke.append({"params": p, "tc_abs_err": tc_err,
                      "verdict": res.verdict,
                      "refine": res.gate.get("refine")})

    # ── live OOD battery: genuinely out-of-distribution inputs must NOT
    # come back confident — verdict != HIGH or the refinement gate fires
    from posteriflow_torch.inference.preprocessing import (PreparedData,
                                                           prepare_simulated,
                                                           quality_checks)
    from posteriflow_torch.physics.constants import N_SAMPLES

    rng = np.random.default_rng(args.seed)

    def _prep(strain):
        # run the real-path quality checks so the verdict sees the same
        # warnings production strain would carry
        quality, warnings = {}, []
        for d_i, det in enumerate(("H1", "L1", "V1")):
            q, w = quality_checks(strain[d_i].astype(np.float32), det)
            quality[det] = q
            warnings += w
        return PreparedData(strain=strain.astype(np.float32), asds=None,
                            asd_bands=np.zeros((3, cfg.sim.psd_bands),
                                               np.float32),
                            detectors_present=["H1", "L1", "V1"],
                            quality=quality, warnings=warnings, timings={})

    # 1. glitch-only: loud sine-Gaussian bursts in unit noise, no signal
    glitch = rng.standard_normal((3, N_SAMPLES))
    t = np.arange(N_SAMPLES)
    for d_i, c in ((0, 6000), (1, 9000), (2, 11000)):
        x = t - c
        glitch[d_i] += 14.0 * np.exp(-x ** 2 / (2 * 40.0 ** 2)) \
            * np.sin(2 * np.pi * x / 55.0)
    # 2. out-of-prior masses: 160+120 Msun (prior box tops at 100)
    oop = {"mass_1": 160.0, "mass_2": 120.0, "luminosity_distance": 900.0,
           "ra": 2.0, "dec": -0.4, "theta_jn": 0.8, "psi": 0.5,
           "phase": 0.7, "geocent_time": 0.0, "a1": 0.3, "a2": 0.2}
    # 3. mis-whitened strain: a valid (aligned-spin) injection scaled 6x
    #    (violates the unit-variance whitening contract)
    prep_ok = prepare_simulated(
        [dict(smoke_params[0], ra=1.0, dec=0.3, theta_jn=0.5, psi=0.4,
              phase=1.0, geocent_time=0.1, a1=0.1, a2=0.05)],
        seed=9, psd_bands=cfg.sim.psd_bands, device=device)
    miswhite = np.asarray(prep_ok.strain) * 6.0

    # ── glitch+SIGNAL robustness: loud injection + burst glitch in one
    # detector; the posterior must stay accurate or the event flagged
    def _add_glitch(strain, det, center, amp, width=45.0, period=60.0):
        s = np.array(strain, copy=True)
        x = t - center
        s[det] += amp * np.exp(-x ** 2 / (2 * width ** 2)) \
            * np.sin(2 * np.pi * x / period)
        return s

    gs_truth = dict(smoke_params[0], ra=1.0, dec=0.3, theta_jn=0.5,
                    psi=0.4, phase=1.0, geocent_time=0.1, a1=0.1, a2=0.05)
    gs_prep = prepare_simulated([gs_truth], seed=21,
                                psd_bands=cfg.sim.psd_bands,
                                param_names=cfg.npe.param_names,
                                device=device)
    mc_true = (gs_truth["mass_1"] * gs_truth["mass_2"]) ** 0.6 \
        / (gs_truth["mass_1"] + gs_truth["mass_2"]) ** 0.2
    glitch_signal = []
    for det, center, amp in ((0, 8192, 8.0), (1, 7000, 12.0),
                             (2, 9500, 6.0)):
        contaminated = _add_glitch(gs_prep.strain, det, center, amp)
        r = infer(engine, data=_prep(contaminated), n_samples=512, seed=47)
        med = r.median()
        tc_err = abs(float(med[8]) - gs_truth["geocent_time"])
        mc_med = float((med[0] * med[1]) ** 0.6 / (med[0] + med[1]) ** 0.2)
        mc_frac = abs(mc_med - mc_true) / mc_true
        flagged = (r.verdict != "HIGH") or bool(r.gate.get("refine"))
        handled = (tc_err < 0.1 and mc_frac < 0.2) or flagged
        glitch_signal.append({"det": det, "amp": amp,
                              "tc_abs_err": tc_err,
                              "mc_frac_err": mc_frac,
                              "verdict": r.verdict, "flagged": flagged,
                              "handled": handled})
    glitch_signal_frac = float(np.mean([c["handled"]
                                        for c in glitch_signal]))

    ood_cases = [("glitch_only", {"data": _prep(glitch)}),
                 ("out_of_prior_mass", {"inject": [oop]}),
                 ("mis_whitened", {"data": _prep(miswhite)})]
    ood_live = []
    for name, kw in ood_cases:
        r = infer(engine, n_samples=512, seed=31, **kw)
        flagged = (r.verdict != "HIGH") or bool(r.gate.get("refine"))
        ood_live.append({"case": name, "verdict": r.verdict,
                         "ood_percentile":
                             r.diagnostics.get("ood_percentile"),
                         "refine": r.gate.get("refine"),
                         "flagged": flagged})
    ood_flag_frac = float(np.mean([c["flagged"] for c in ood_live]))

    metrics = {
        "ood_live": ood_live,
        "ood_flag_frac": ood_flag_frac,
        "glitch_signal": glitch_signal,
        "glitch_signal_handled_frac": glitch_signal_frac,
        "shuffle_delta_nll": avg("shuffle_delta_nll"),
        "dist_corr": avg("dist_corr"),
        "val_nll": avg("val_nll_diag"),
        "cov50_violations": cov50_viol,
        "cov90_violations": cov90_viol,
        "cov50_all": dict(zip(PARAM_NAMES, cov50.round(3).tolist())),
        "cov90_all": dict(zip(PARAM_NAMES, cov90.round(3).tolist())),
        "sbc_pass_frac": frac,
        "sbc_ks_p": dict(zip(PARAM_NAMES, np.round(ps, 5).tolist())),
        "spurious_railing": railing,
        "base_conc": float(np.mean([c["base_conc"] for c in chunks])),
        "smoke_tc_max_abs_err": max(tc_errs),
        "smoke_tests": smoke,
        "n_events": n_chunks * CHUNK,
        "n_events_nominal": args.n_events,
        "n_post": args.n_post,
        "wall_time_s": round(time.time() - t_start, 1),
    }
    record = {
        "chunks": [dict(c["diag"], spurious_railing=c["spurious_railing"],
                        base_conc=c["base_conc"]) for c in chunks],
        "seconds": {"chunks": t_chunks - t_start,
                    "real_domain": t_real - t_chunks,
                    "ood_fit": t_ood - t_real,
                    "batteries": time.time() - t_ood},
    }

    gates = dict(GATES)
    if real_metrics:
        metrics.update(real_metrics)
        metrics["real_gaussian_nll_gap"] = (real_metrics["real_val_nll"]
                                            - metrics["val_nll"])
        gates.update(REAL_GATE)

    checks = [_check(k, metrics[k], spec) for k, spec in gates.items()]
    all_pass = all(c["passed"] for c in checks)
    from posteriflow_torch.utils.provenance import artifact_meta
    report = {"passed": all_pass, "checks": checks, "metrics": metrics,
              "checkpoint": str(Path(args.ckpt) / args.name),
              "_meta": artifact_meta(Path(args.ckpt) / args.name,
                                     param_names=list(cfg.npe.param_names))}

    outdir = Path(args.out or (Path(args.ckpt).parent / "validation"))
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "report.json").write_text(json.dumps(report, indent=2,
                                                   default=float))
    _write_html(outdir / "report.html", report)
    for c in checks:
        log.info("%-24s %10.4f %2s %-8s %s", c["gate"], c["value"], c["op"],
                 c["threshold"], "PASS" if c["passed"] else "FAIL")
    log.info("overall: %s -> %s", "PASS" if all_pass else "FAIL", outdir)
    return (0 if all_pass else 1), report, record


def main(argv=None) -> int:
    return run(argv)[0]


def _write_html(path, report):
    rows = "".join(
        f"<tr class={'ok' if c['passed'] else 'bad'}><td>{c['gate']}</td>"
        f"<td>{c['value']:.4f}</td><td>{c['op']} {c['threshold']}</td>"
        f"<td>{'PASS' if c['passed'] else 'FAIL'}</td></tr>"
        for c in report["checks"])
    html = f"""<html><head><style>
body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px}}.ok{{background:#e6f4e6}}
.bad{{background:#f8d7da}}</style></head><body>
<h2>posteriflow-tpu checkpoint validation —
{'PASS' if report['passed'] else 'FAIL'}</h2>
<p>checkpoint: {report['checkpoint']}</p>
<table><tr><th>gate</th><th>value</th><th>threshold</th><th>status</th></tr>
{rows}</table>
<h3>full metrics</h3><pre>{json.dumps(report['metrics'], indent=2,
                                      default=float)}</pre>
</body></html>"""
    Path(path).write_text(html)


if __name__ == "__main__":
    sys.exit(main())
