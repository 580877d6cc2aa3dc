"""Physics validation suite as a standalone gate -> JSON and an exit code.

The port's twin of scripts/validate_pipeline_physics.py: nine checks, with
JAX's thresholds, on --device (default cuda):
  1. coloured design noise whitens to unit variance (std in (0.9, 1.1));
  2. noise-only simulated events decorrelate across detectors (|r| < 0.1);
  3. the matched-filter SNR scales as 1/d_L (SNR(100)/SNR(400) = 4 ± 0.01);
  4. the H1-L1 geometric delays reach the baseline and not past it;
  5. the antenna pattern's mean F₊² over the sky is 0.2 ± 0.02;
  6. the prior orders its masses (m1 >= m2);
  7. every live simulated signal passes the SNR gate (>= 8);
  8. PhenomD's inspiral matches TaylorF2's on 20-50 Hz (|ΔΨ| < 5 rad,
     amplitude ratio > 0.7);
  9. PhenomD's amplitude peak sits in (0.5, 1.05) f_ringdown.
Checks 3, 4, 8 and 9 are deterministic; the rest draw from torch
generators with the JAX script's seeds (0-6), so their values are the
same statistics of other draws. "backend" names the device (and the card).

Usage:
  python -m posteriflow_torch.tools.validate_pipeline_physics [--device cpu] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def backend_name(device) -> str:
    """The device's type, and the card's name on a GPU."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return device.type


def run(argv=None) -> dict:
    """The nine checks -> the report {"passed", "backend", "checks"}."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from posteriflow_torch.physics import constants as C
    from posteriflow_torch.physics.detectors import (VERTICES,
                                                     antenna_pattern,
                                                     time_delay_from_geocenter)
    from posteriflow_torch.physics.psd import aligo_psd, asd_from_psd
    from posteriflow_torch.physics.simulator import SimConfig, simulate_batch
    from posteriflow_torch.physics.waveforms.phenomd import (
        _ring_damp_geo, phenomd_amp_phase)
    from posteriflow_torch.physics.waveforms.taylorf2 import (
        taylorf2_amp_phase, taylorf2_polarizations)
    from posteriflow_torch.physics.whiten import (colored_noise_td,
                                                  matched_filter_snr_fd,
                                                  whiten_td)
    from posteriflow_torch.prior import PriorConfig, sample_batch

    dev = torch.device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def t(*vals):
        return [torch.tensor([[float(v)]], device=dev) for v in vals]

    freqs = torch.as_tensor(np.asarray(C.FREQS, np.float32), device=dev)
    asd = asd_from_psd(aligo_psd(C.FREQS), device=dev)
    checks = []

    def check(name, ok, detail):
        checks.append({"check": name, "passed": bool(ok), "detail": detail})

    with torch.no_grad():
        # 1. unit-variance whitening
        noise = colored_noise_td(asd, generator=gen(0), batch_shape=(8,))
        std = float(torch.std(whiten_td(noise, asd)))
        check("unit_variance_whitening", 0.9 < std < 1.1, {"std": std})

        # 2. inter-detector noise decorrelation
        batch = simulate_batch(16, SimConfig(prior=PriorConfig(
            noise_fraction=1.0)), device=dev, generator=gen(1))
        s = batch.strain.double().cpu().numpy()
        cors = [abs(np.corrcoef(s[i, a], s[i, b])[0, 1])
                for i in range(16) for a, b in ((0, 1), (0, 2), (1, 2))]
        check("noise_decorrelation", max(cors) < 0.1,
              {"max_corr": float(max(cors))})

        # 3. 1/d_L amplitude scaling
        def snr_at(d):
            hp, _ = taylorf2_polarizations(freqs, *t(1.4, 1.4, 0.0, 0.0, d,
                                                     0.0, 0.0))
            return matched_filter_snr_fd(hp, asd)
        ratio = float(snr_at(100.0) / snr_at(400.0))
        check("inverse_distance_amplitude", abs(ratio - 4.0) < 0.01,
              {"snr_ratio_100_400": ratio})

        # 4. geometric time delays
        ra = torch.linspace(0, 2 * np.pi, 24, device=dev)
        dec = torch.linspace(-1.4, 1.4, 12, device=dev)
        dd, rr = torch.meshgrid(dec, ra, indexing="ij")
        delays = time_delay_from_geocenter(rr, dd, torch.zeros_like(rr))
        base_hl = float(np.linalg.norm(VERTICES[0] - VERTICES[1]) / C.C_SI)
        max_dt = float(torch.max(torch.abs(delays[..., 0]
                                           - delays[..., 1])))
        check("geometric_time_delays",
              max_dt <= base_hl + 1e-5 and max_dt >= 0.8 * base_hl,
              {"max_H1L1_delay_ms": max_dt * 1e3,
               "baseline_ms": base_hl * 1e3})

        # 5. antenna patterns
        raa = 2 * np.pi * torch.rand(5000, generator=gen(2), device=dev)
        dec2 = torch.asin(2.0 * torch.rand(5000, generator=gen(3),
                                           device=dev) - 1.0)
        psi = np.pi * torch.rand(5000, generator=gen(4), device=dev)
        fp, _ = antenna_pattern(0, raa, dec2, psi, torch.zeros(5000,
                                                               device=dev))
        mfp = float(torch.mean(fp ** 2))
        check("antenna_pattern_mean", abs(mfp - 0.2) < 0.02,
              {"mean_Fplus_sq": mfp})

        # 6 + 7. prior distributions before and after the SNR cut
        params, _ = sample_batch(4096, generator=gen(5), device=dev)
        p = params.reshape(-1, params.shape[-1]).cpu().numpy()
        check("prior_mass_ordering", bool((p[:, 0] >= p[:, 1] - 1e-5).all()),
              {})
        gated = simulate_batch(64, SimConfig(), device=dev, generator=gen(6))
        snrs = gated.sig_snr.cpu().numpy()
        live = snrs[np.arange(snrs.shape[1])[None]
                    < gated.n_sig.cpu().numpy()[:, None]]
        check("snr_gate", bool((live >= 8.0 - 1e-4).all()),
              {"min_live_snr": float(live.min()) if live.size else None})

        # 8. PhenomD's inspiral phase against TaylorF2
        band = torch.arange(80, 200, dtype=torch.float32, device=dev) * 0.25
        wf = (36.0, 29.0, 0.3, -0.1, 400.0, 0.0)
        amp_d, psi_d = phenomd_amp_phase(band, *t(*wf))
        amp_t, psi_t = taylorf2_amp_phase(band, *t(*wf))
        dpsi = float(torch.max(torch.abs(psi_d - psi_t)))
        ratio_lo = float(torch.min(amp_d / amp_t))
        check("phenomd_inspiral_consistency",
              dpsi < 5.0 and 0.7 < ratio_lo,
              {"max_phase_diff_rad": dpsi, "min_amp_ratio": ratio_lo})

        # 9. PhenomD's amplitude peak below (and near) the ringdown
        full = torch.arange(1, 8193, dtype=torch.float32, device=dev) * 0.25
        amp_f, _ = phenomd_amp_phase(full, *t(*wf), phase=False)
        f_np = full.cpu().numpy()
        eff = amp_f[0].cpu().numpy() * f_np ** (7.0 / 6.0)
        msec = (wf[0] + wf[1]) * C.MTSUN_SI
        eta = wf[0] * wf[1] / (wf[0] + wf[1]) ** 2
        f_rd_hz = float(_ring_damp_geo(*t(eta, wf[2], wf[3]))[0]) / msec
        f_pk = float(f_np[int(np.argmax(eff))])
        check("phenomd_amplitude_peak", 0.5 * f_rd_hz < f_pk < 1.05 * f_rd_hz,
              {"f_peak_hz": f_pk, "f_ringdown_hz": f_rd_hz})

    report = {"passed": all(c["passed"] for c in checks),
              "backend": backend_name(dev), "checks": checks}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    report = run(argv)
    print(json.dumps(report, indent=2))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
