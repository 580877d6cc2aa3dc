"""Build a real-noise bank in the bank format (the twin of
scripts/download_gwosc_noise_bank.py; numpy and scipy only).

Segments of 64 s, whitened by their own median ASD (so the whitening
filter equals the training re-colour denominator by construction),
sub-18 Hz zeroing, 2 s edge trim, unit floor, and a kurtosis/std quality
gate. Two modes:

  --synthetic N     no network: unit white segments with randomized smooth
                    sensitivities, N a detector, from numpy's
                    default_rng(--seed); the same files in the same order
                    as the JAX script
  --gps-list FILE   gwpy fetch of real segments (needs gwpy and network)

    python -m posteriflow_torch.tools.make_noise_bank --out data/noise_bank \\
        --synthetic 16
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

log = logging.getLogger("posteriflow.data")


def quality_gate(white: np.ndarray) -> bool:
    """The bank's gates: |kurtosis| < 1 and 0.5 < std < 3."""
    from scipy.stats import kurtosis
    std = float(np.std(white))
    k = float(kurtosis(white))
    ok = 0.5 < std < 3.0 and abs(k) < 1.0
    if not ok:
        log.warning("segment rejected: std=%.2f kurtosis=%.2f", std, k)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="make N synthetic segments per detector")
    ap.add_argument("--gps-list", help="file of GPS start times (real mode)")
    ap.add_argument("--segment-seconds", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from posteriflow_torch.data.noise_bank import save_bank_segment
    from posteriflow_torch.physics.constants import (DETECTORS, FREQS,
                                                     SAMPLE_RATE)
    from posteriflow_torch.physics.psd import psd_for

    out = Path(args.out)
    rng = np.random.default_rng(args.seed)
    n_seg = int(args.segment_seconds * SAMPLE_RATE)

    if args.synthetic:
        for det in DETECTORS:
            design_asd = np.sqrt(psd_for(det))
            made = 0
            gps = 1262000000
            while made < args.synthetic:
                # randomized smooth sensitivity deviation from design
                dev = np.interp(np.linspace(0, 1, len(FREQS)),
                                np.linspace(0, 1, 8),
                                rng.normal(0, 0.25, 8))
                measured_asd = design_asd * np.exp(dev)
                # noise at the measured sensitivity whitened by its own ASD
                # is unit white (the bank's storage convention)
                white = rng.standard_normal(n_seg)
                if not quality_gate(white):
                    continue
                save_bank_segment(out, det, gps, white, measured_asd)
                made += 1
                gps += 4096
            log.info("%s: %d synthetic segments", det, made)
        log.info("bank -> %s", out)
        return str(out)

    if not args.gps_list:
        ap.error("need --synthetic N or --gps-list FILE")
    try:
        from gwpy.timeseries import TimeSeries
    except ImportError as e:
        raise ImportError("real mode needs gwpy (network); use "
                          "--synthetic for offline banks") from e
    from posteriflow_torch.inference.preprocessing import (_highpass,
                                                           _median_asd)
    gps_times = [float(t) for t in Path(args.gps_list).read_text().split()]
    for det in DETECTORS:
        for gps in gps_times:
            ts = TimeSeries.fetch_open_data(
                det, gps, gps + args.segment_seconds)
            x = np.asarray(ts.resample(SAMPLE_RATE).value, dtype=np.float64)
            x = _highpass(x, SAMPLE_RATE)
            asd = _median_asd(x, SAMPLE_RATE)
            f_full = np.fft.rfftfreq(len(x), 1.0 / SAMPLE_RATE)
            asd4 = np.interp(FREQS, f_full[:len(asd)], asd)
            xf = np.fft.rfft(x) / np.interp(f_full, FREQS, asd4)
            xf[f_full < 18.0] = 0.0
            y = np.fft.irfft(xf, n=len(x)) * np.sqrt(2.0 / SAMPLE_RATE)
            trim = 2 * SAMPLE_RATE
            y = y[trim:-trim]
            y = y / max(np.std(y), 1e-9)
            if quality_gate(y):
                save_bank_segment(out, det, int(gps), y, asd4)
    return str(out)


if __name__ == "__main__":
    main()
