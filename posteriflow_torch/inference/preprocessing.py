"""Data preparation for inference on real strain (numpy/scipy).

Copy of the real-data half of posteriflow_tpu/inference/preprocessing.py
(:66-206), with the reference semantics (src/ahsd/inference/
preprocessing.py):
  - PreparedData carries whitened strain + ASDs + quality + warnings +
    stage timings;
  - highpass 15 Hz, median-ASD estimate on the long segment, manual
    irfft(rfft(x)/ASD) whitening, sub-18 Hz zeroing, 2 s edge trim,
    off-source unit-floor normalization;
  - missing detectors are filled with unit white noise, the fill detector
    dropout trains with;
  - quality checks: finite, whitened std in (0.5, 3), |x| > 40σ glitch,
    off-source kurtosis, repeated samples;
  - asd_bands with the training definition: band-mean
    log(ASD_design / ASD_measured) over K log bands.
Simulated injections (`prepare_simulated`, :209-257 of the JAX module) go
through the port's simulator on the device. `fetch_gwosc` (:266-285) is
gated on gwpy, as in JAX: without it, it raises JAX's ImportError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from posteriflow_torch.physics.constants import (DETECTORS, FREQS, GPS_REF,
                                                 N_SAMPLES, SAMPLE_RATE)
from posteriflow_torch.physics.psd import default_network_psd

_DESIGN_ASD = np.sqrt(default_network_psd())          # [3, N_RFFT] physical


@dataclasses.dataclass
class PreparedData:
    """Whitened, analysis-ready 3-detector strain."""
    strain: np.ndarray                 # [3, N_SAMPLES] whitened float32
    asds: np.ndarray                   # [3, N_RFFT] physical ASD used
    asd_bands: np.ndarray              # [3, K] sensitivity summary
    detectors_present: List[str]
    quality: Dict[str, dict]
    warnings: List[str]
    timings: Dict[str, float]
    gps_time: float = GPS_REF
    truth: Optional[np.ndarray] = None  # [n_sig, P] for injections


def quality_checks(white: np.ndarray, det: str) -> tuple[dict, list]:
    """Per-detector whitened-strain quality (reference thresholds
    preprocessing.py:67-92)."""
    from scipy.stats import kurtosis
    warnings = []
    q = {}
    q["finite"] = bool(np.isfinite(white).all())
    if not q["finite"]:
        warnings.append(f"{det}: non-finite samples")
        white = np.nan_to_num(white)
    q["std"] = float(np.std(white))
    if not (0.5 < q["std"] < 3.0):
        warnings.append(f"{det}: whitened std {q['std']:.2f} outside "
                        f"(0.5, 3)")
    q["max_abs"] = float(np.max(np.abs(white)))
    if q["max_abs"] > 40.0:
        warnings.append(f"{det}: |x| {q['max_abs']:.0f}σ glitch candidate")
    # off-source kurtosis: outer seconds (merger lives near the center)
    edge = int(0.5 * SAMPLE_RATE)
    off = np.concatenate([white[:edge], white[-edge:]])
    q["kurtosis"] = float(kurtosis(off))
    if abs(q["kurtosis"]) > 3.0:
        warnings.append(f"{det}: off-source kurtosis {q['kurtosis']:.1f}")
    rep = np.mean(np.diff(white) == 0.0)
    q["repeated_frac"] = float(rep)
    if rep > 0.01:
        warnings.append(f"{det}: {rep:.1%} repeated samples")
    return q, warnings


def asd_bands_from_measured(measured_asd: np.ndarray,
                            psd_bands: int = 16) -> np.ndarray:
    """[3, K] band-mean log(ASD_design / ASD_measured) over log-spaced
    bands 20 Hz .. Nyquist — 0 for design sensitivity, negative where the
    detector is LESS sensitive than design (training definition:
    remix_data.py:301-311, preprocessing.py:226-249)."""
    edges = np.geomspace(20.0, SAMPLE_RATE / 2.0, psd_bands + 1)
    out = np.zeros((len(DETECTORS), psd_bands), dtype=np.float32)
    for d in range(len(DETECTORS)):
        ratio = np.log(np.maximum(_DESIGN_ASD[d], 1e-30)
                       / np.maximum(measured_asd[d], 1e-30))
        for k in range(psd_bands):
            sel = (FREQS >= edges[k]) & (FREQS < edges[k + 1])
            out[d, k] = float(ratio[sel].mean()) if sel.any() else 0.0
    return out


def _median_asd(x: np.ndarray, fs: int, seg_seconds: float = 4.0):
    """Median-of-segments ASD estimate (glitch-robust, like the reference's
    gwpy median method). x: long raw strain."""
    nper = int(seg_seconds * fs)
    n_seg = len(x) // nper
    segs = x[:n_seg * nper].reshape(n_seg, nper)
    win = np.hanning(nper)
    wnorm = (win ** 2).sum() / nper
    ps = np.abs(np.fft.rfft(segs * win, axis=-1)) ** 2
    psd = np.median(ps, axis=0) / (0.4514 * wnorm)   # median->mean bias corr
    psd *= 2.0 / (fs * nper)
    return np.sqrt(np.maximum(psd, 1e-60))


def _highpass(x: np.ndarray, fs: int, fc: float = 15.0) -> np.ndarray:
    from scipy.signal import butter, sosfiltfilt
    sos = butter(8, fc, btype="highpass", fs=fs, output="sos")
    return sosfiltfilt(sos, x)


def prepare_real(strain_by_det: Dict[str, np.ndarray],
                 gps_time: float = GPS_REF,
                 sample_rate: int = SAMPLE_RATE,
                 psd_bands: int = 16,
                 asd_by_det: Optional[Dict[str, np.ndarray]] = None
                 ) -> PreparedData:
    """Long (≥16 s, ideally 64 s) RAW strain per detector, centered on the
    event -> whitened 4 s analysis window (reference real path:
    preprocessing.py:103-158). Missing detectors get unit white noise.

    asd_by_det: optional measured PHYSICAL ASDs on the FREQS grid
    (physics.psd.load_asd_file output), overriding the median-ASD estimate
    per detector — the reference's bilby --psd file path
    (infer.py --psd, bilby_pipeline.py:95-99)."""
    t0 = time.time()
    timings = {}
    rng = np.random.default_rng(12345)
    white = np.zeros((len(DETECTORS), N_SAMPLES), dtype=np.float32)
    asds = _DESIGN_ASD.copy()
    present, warnings, quality = [], [], {}

    for i, det in enumerate(DETECTORS):
        raw = strain_by_det.get(det)
        if raw is None:
            white[i] = rng.standard_normal(N_SAMPLES).astype(np.float32)
            quality[det] = {"missing": True}
            continue
        present.append(det)
        x = np.asarray(raw, dtype=np.float64)
        x = _highpass(x, sample_rate)
        if asd_by_det is not None and det in asd_by_det:
            asd4 = np.asarray(asd_by_det[det], dtype=np.float64)
            if asd4.shape != FREQS.shape:
                raise ValueError(f"{det}: ASD override must be on the FREQS "
                                 f"grid ({FREQS.shape[0]} bins)")
        else:
            seg_asd = _median_asd(x, sample_rate)
            # interpolate measured ASD (long-segment grid) to the 4 s grid
            f_est = np.fft.rfftfreq((len(x) // int(4.0 * sample_rate))
                                    and int(4.0 * sample_rate),
                                    1.0 / sample_rate)
            asd4 = np.interp(FREQS, f_est[:len(seg_asd)], seg_asd)
        asds[i] = asd4

        # manual whitening of the whole segment, then cut the window
        xf = np.fft.rfft(x)
        f_full = np.fft.rfftfreq(len(x), 1.0 / sample_rate)
        asd_full = np.interp(f_full, FREQS, asd4)
        xf = xf / np.maximum(asd_full, 1e-30)
        xf[f_full < 18.0] = 0.0                       # sub-18 Hz zeroing
        y = np.fft.irfft(xf, n=len(x)) * np.sqrt(2.0 / sample_rate)

        # trim 2 s edges (filter transients), take centered 4 s window
        trim = 2 * sample_rate
        y = y[trim:-trim]
        mid = len(y) // 2
        half = N_SAMPLES // 2
        w = y[mid - half: mid + half]
        # off-source unit-floor normalization
        edge = int(0.5 * sample_rate)
        floor = np.std(np.concatenate([w[:edge], w[-edge:]]))
        if floor > 0:
            w = w / floor
        white[i] = w.astype(np.float32)
        q, warn = quality_checks(white[i], det)
        quality[det] = q
        warnings += warn

    timings["prepare"] = time.time() - t0
    return PreparedData(strain=white, asds=asds,
                        asd_bands=asd_bands_from_measured(asds, psd_bands),
                        detectors_present=present, quality=quality,
                        warnings=warnings, timings=timings,
                        gps_time=gps_time)


_PRECESSION_KEYS = ("tilt_1", "tilt_2", "phi_12", "phi_jl")


def prepare_simulated(params_list, seed: int = 0, psd_bands: int = 16,
                      add_noise: bool = True, param_names=None,
                      device="cuda",
                      generator: Optional["torch.Generator"] = None,
                      draws=None) -> PreparedData:
    """A fresh injection through the training simulator on `device`.

    params_list: [n_sig] dicts keyed by param_names (default PARAM_NAMES;
    PARAM_NAMES_PRECESSING for 15-D injections, where an omitted
    precession key means 0.0, the aligned limit; a missing base key raises
    KeyError) or an [n_sig, P] array. The gate keeps every signal
    (min_snr 0) and ranks them by loudness, so `truth` is in rank order.
    The noise comes from `draws` (physics.simulator.SimDraws of one
    event) if given, else from `generator`, else from a generator on
    `device` seeded with `seed`."""
    import torch

    from posteriflow_torch import PARAM_NAMES
    from posteriflow_torch.physics.simulator import (SimConfig, design_asd,
                                                     draw_events,
                                                     simulate_event)
    from posteriflow_torch.prior import PriorConfig

    t0 = time.time()
    if param_names is None:
        param_names = PARAM_NAMES
    if isinstance(params_list, np.ndarray):
        arr = np.asarray(params_list, dtype=np.float32)
    else:
        arr = np.array(
            [[float(p.get(k, 0.0)) if k in _PRECESSION_KEYS else float(p[k])
              for k in param_names] for p in params_list],
            dtype=np.float32)
    n_sig = arr.shape[0]
    cfg = SimConfig(prior=PriorConfig(max_signals=max(n_sig, 1),
                                      precessing=arr.shape[1] >= 15),
                    min_snr=0.0, psd_bands=psd_bands, add_noise=add_noise)
    device = torch.device(device)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        draws = draw_events((), generator, device)
    ev = simulate_event(torch.as_tensor(arr, device=device), n_sig,
                        design_asd(device), cfg, draws)
    strain = ev.strain.cpu().numpy()
    quality, warnings = {}, []
    for i, det in enumerate(DETECTORS):
        q, warn = quality_checks(strain[i], det)
        quality[det] = q
        warnings += warn
    return PreparedData(strain=strain, asds=_DESIGN_ASD.copy(),
                        asd_bands=np.zeros((3, psd_bands), np.float32),
                        detectors_present=list(DETECTORS), quality=quality,
                        warnings=warnings,
                        timings={"prepare": time.time() - t0},
                        truth=ev.params[:n_sig].cpu().numpy())


def fetch_gwosc(event: Optional[str] = None, gps: Optional[float] = None,
                detectors=DETECTORS, duration: float = 64.0):
    """Fetch open strain around an event or GPS time through gwpy ->
    ({det: strain at SAMPLE_RATE}, gps). Needs gwpy and GWOSC network
    access."""
    try:
        from gwpy.timeseries import TimeSeries
    except ImportError as e:
        raise ImportError(
            "fetch_gwosc requires gwpy (GWOSC network access). Install "
            "gwpy, or pass local strain to prepare_real / use "
            "prepare_simulated for injections.") from e
    from gwosc.datasets import event_gps
    if gps is None:
        gps = event_gps(event)
    out = {}
    for det in detectors:
        ts = TimeSeries.fetch_open_data(det, gps - duration / 2,
                                        gps + duration / 2)
        out[det] = ts.resample(SAMPLE_RATE).value
    return out, gps
