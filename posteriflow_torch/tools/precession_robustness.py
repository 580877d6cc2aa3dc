"""Precession systematics study: how does an aligned-spin-trained NPE
respond to genuinely precessing injections?

The port's twin of scripts/precession_robustness.py: one injection at each
chi_p in --chi-p (0 is the control that matches the training physics),
the same noise for every chi_p, through `infer` on --device: the injected
(noise-free) network SNR, the OOD verdict and percentile, the refinement
gate, the posterior medians and widths and each parameter's z offset from
the truth. The signal is precessing_signal_white_fd, the precessing
twist of PhenomD(+matter), on the design ASD.

Usage:
  python -m posteriflow_torch.tools.precession_robustness --ckpt model_release/npe_r3_best \\
      --out reports/precession_robustness_torch.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

# a moderately inclined injection (the precession modulation shows),
# mid-band masses, a1 = 0.3 aligned primary spin the twist precesses around
_TRUTH = {
    "mass_1": 36.0, "mass_2": 29.0, "luminosity_distance": 600.0,
    "ra": 1.1, "dec": -0.4, "theta_jn": 1.05, "psi": 0.9, "phase": 1.2,
    "geocent_time": 0.05, "a1": 0.3, "a2": -0.1,
}


def make_strain(theta, chi_p: float, asd, noise):
    """(whitened strain [3, N] = signal + noise, the signal's network SNR)
    for the 11 parameters theta on the ASD's device."""
    import torch

    from posteriflow_torch.physics.constants import N_SAMPLES
    from posteriflow_torch.physics.waveforms.precession import \
        precessing_signal_white_fd
    from posteriflow_torch.physics.whiten import fd_white_to_td
    sig_fd = precessing_signal_white_fd(theta, chi_p, asd)
    sig_td = fd_white_to_td(sig_fd, N_SAMPLES)
    snr = torch.sqrt(torch.sum(torch.abs(sig_fd) ** 2))
    return sig_td + noise, float(snr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", default="model_release/npe_r3_best")
    ap.add_argument("--name", default="best")
    ap.add_argument("--chi-p", type=float, nargs="+",
                    default=[0.0, 0.3, 0.6])
    ap.add_argument("--n-samples", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="reports/precession_robustness_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    import torch

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.inference.pipeline import InferenceEngine, infer
    from posteriflow_torch.inference.preprocessing import (_DESIGN_ASD,
                                                           PreparedData)
    from posteriflow_torch.physics.constants import DETECTORS, N_SAMPLES
    from posteriflow_torch.physics.psd import default_network_asd

    dev = torch.device(args.device)
    engine = InferenceEngine.from_checkpoint(args.ckpt, args.name,
                                             device=dev)
    asd = default_network_asd(device=dev)
    theta = torch.tensor([_TRUTH[k] for k in PARAM_NAMES],
                         dtype=torch.float32, device=dev)
    noise = torch.randn((len(DETECTORS), N_SAMPLES), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            args.seed))               # the same for every chi_p
    rows = []
    for chi_p in args.chi_p:
        t0 = time.time()
        with torch.no_grad():
            strain, snr = make_strain(theta, float(chi_p), asd, noise)
        data = PreparedData(
            strain=strain.cpu().numpy(), asds=_DESIGN_ASD.copy(),
            asd_bands=np.zeros((3, engine.cfg.psd_bands), np.float32),
            detectors_present=list(DETECTORS), quality={}, warnings=[],
            timings={}, truth=theta.cpu().numpy()[None])
        res = infer(engine, data=data, n_samples=args.n_samples,
                    seed=args.seed)
        samp = np.asarray(res.samples)
        truth = theta.cpu().numpy()
        med = np.median(samp, axis=0)
        std = samp.std(axis=0)
        z = (med - truth) / np.maximum(std, 1e-9)
        row = {
            "chi_p": float(chi_p),
            "injected_snr": snr,
            "verdict": res.verdict,
            "ood_percentile": float(res.diagnostics.get(
                "ood_percentile", float("nan"))),
            "refine": bool(res.gate.get("refine", False)),
            "median": {k: float(m) for k, m in zip(PARAM_NAMES, med)},
            "posterior_std": {k: float(s) for k, s in zip(PARAM_NAMES, std)},
            "z_offset": {k: float(v) for k, v in zip(PARAM_NAMES, z)},
            "max_abs_z": float(np.max(np.abs(z))),
            "wall_s": round(time.time() - t0, 2),
        }
        rows.append(row)
        log.info("chi_p=%.1f snr=%.1f verdict=%s ood=%.1f%% max|z|=%.2f",
                 chi_p, row["injected_snr"], row["verdict"],
                 row["ood_percentile"], row["max_abs_z"])

    out = {
        "truth": _TRUTH,
        "ckpt": args.ckpt,
        "n_samples": args.n_samples,
        "note": ("aligned-trained NPE on precessing twist-up injections; "
                 "chi_p=0 is the aligned control, chi_p>0 precesses"),
        "cases": rows,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    log.info("-> %s", args.out)
    return out


if __name__ == "__main__":
    main()
