"""Real-noise bank: per-segment-whitened detector noise and the filters that
re-colour design-whitened signals into each segment's whitening, held on
the device and cropped there.

Port of posteriflow_tpu/data/noise_bank.py:33-183, for the synthetic bank
that the benchmark makes from its own draws. At train time each event takes a random 4 s crop per detector (time
flip + sign with p = ½ to decorrelate reused segments), signals re-coloured
into the segment's whitening by the exact linear filter
sig_seg = irfft(rfft(sig_design)·ASD_design/ASD_meas), and asd_bands, the
band-mean log of that filter.

Every random step is a draw and a deterministic apply: `draw_real_noise`
draws (segment, offset, flip) per detector from a torch.Generator, and
`real_noise_from_draws` gathers every crop of a batch in one indexed read
of the flattened segments (a loop per event would read a segment row per
draw). The synthetic bank likewise splits its draws
(`draw_synthetic_bank`) from the knots → interp → exp → clamp that build
its filters (`synthetic_bank_from_draws`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from pfbench.reference.frozen.physics.constants import (DETECTORS, FREQS, N_RFFT,
                                                 N_SAMPLES, SAMPLE_RATE)

RECOLOR_CLAMP = 50.0
N_KNOTS = 8          # knots of a synthetic segment's log-sensitivity curve


@dataclasses.dataclass
class NoiseBank:
    """A bank on the device: segments [n_det, n_seg, L] float16 whitened
    strain; recolor [n_det, n_seg, N_RFFT] float32 design/measured filter;
    asd_bands [n_det, n_seg, K] float32 band summaries of the filter."""
    segments: torch.Tensor
    recolor: torch.Tensor
    asd_bands: torch.Tensor

    @property
    def n_segments(self) -> int:
        return self.segments.shape[1]

    @property
    def segment_len(self) -> int:
        return self.segments.shape[2]


class RealNoiseDraws(NamedTuple):
    """The random draws of real-noise crops, leading dims [...]."""
    seg_idx: torch.Tensor    # [..., n_det] int in [0, n_seg)
    off: torch.Tensor        # [..., n_det] int in [0, L - N_SAMPLES)
    flip: torch.Tensor       # [..., n_det] bool, p = ½: crop -> -crop[::-1]


def _band_mean_log(filt: np.ndarray, psd_bands: int) -> np.ndarray:
    edges = np.geomspace(20.0, SAMPLE_RATE / 2.0, psd_bands + 1)
    out = np.zeros(psd_bands, dtype=np.float32)
    logf = np.log(np.maximum(filt, 1e-30))
    for k in range(psd_bands):
        sel = (FREQS >= edges[k]) & (FREQS < edges[k + 1])
        out[k] = float(logf[sel].mean()) if sel.any() else 0.0
    return out


def draw_synthetic_bank(generator: Optional[torch.Generator] = None,
                        n_segments: int = 4,
                        segment_len: int = 4 * N_SAMPLES,
                        sensitivity_jitter: float = 0.3, device="cuda"):
    """The draws of a synthetic bank: unit white segments
    [n_det, n_seg, L] float16 and the knots [n_det, n_seg, N_KNOTS] of each
    segment's smooth log-sensitivity deviation."""
    kw = dict(generator=generator, device=device)
    n_det = len(DETECTORS)
    segs = torch.randn((n_det, n_segments, segment_len), **kw).to(
        torch.float16)
    knots = sensitivity_jitter * torch.randn((n_det, n_segments, N_KNOTS),
                                             **kw)
    return segs, knots


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) over the last axis of fp (xp increasing),
    with JAX's formula fp[i-1] + (x - xp[i-1])/(xp[i] - xp[i-1])·Δfp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[..., i - 1] + ((x - xp[i - 1]) / dx) * df
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def synthetic_bank_from_draws(segments: torch.Tensor, knots: torch.Tensor,
                              psd_bands: int = 16) -> NoiseBank:
    """The deterministic part of a synthetic bank: each segment's filter
    exp(interp(knots)) on the rfft grid, clamped, and its band summaries."""
    dev = knots.device
    x = torch.linspace(0, 1, N_RFFT, device=dev)
    xk = torch.linspace(0, 1, knots.shape[-1], device=dev)
    filt = torch.clamp(torch.exp(interp(x, xk, knots.to(torch.float32))),
                       1.0 / RECOLOR_CLAMP, RECOLOR_CLAMP)
    host = filt.cpu().numpy()
    bands = np.stack([[_band_mean_log(host[d, s], psd_bands)
                       for s in range(host.shape[1])]
                      for d in range(host.shape[0])])
    return NoiseBank(segments=segments, recolor=filt,
                     asd_bands=torch.from_numpy(bands).to(dev))


def draw_real_noise(batch_shape, bank: NoiseBank,
                    generator: Optional[torch.Generator] = None
                    ) -> RealNoiseDraws:
    """Per event of `batch_shape` and detector: a segment, a crop offset
    in [0, L - N_SAMPLES) and a flip with p = ½, on the bank's device."""
    s = tuple(batch_shape) + (bank.segments.shape[0],)
    kw = dict(generator=generator, device=bank.segments.device)
    return RealNoiseDraws(
        seg_idx=torch.randint(0, bank.n_segments, s, **kw),
        off=torch.randint(0, bank.segment_len - N_SAMPLES, s, **kw),
        flip=torch.rand(s, **kw) < 0.5)


def real_noise_from_draws(bank: NoiseBank, draws: RealNoiseDraws):
    """The crops of `draws` -> (noise [..., n_det, N_SAMPLES] float32,
    recolor [..., n_det, N_RFFT], asd_bands [..., n_det, K]).

    Every crop is one row of a strided view of the flattened segments
    (row r = samples r .. r + N_SAMPLES - 1), so the batch is one gather
    that reads each crop once."""
    n_det, n_seg, length = bank.segments.shape
    det = torch.arange(n_det, device=bank.segments.device)
    flat = bank.segments.reshape(-1)
    windows = flat.as_strided((flat.numel() - N_SAMPLES + 1, N_SAMPLES),
                              (1, 1))
    start = (det * n_seg + draws.seg_idx) * length + draws.off
    crop = windows[start].to(torch.float32)
    crop = torch.where(draws.flip[..., None], -crop.flip(-1), crop)
    return (crop, bank.recolor[det, draws.seg_idx],
            bank.asd_bands[det, draws.seg_idx])
