"""Long-duration BNS NPE (torch): 64-s binary-neutron-star inspirals.

Port of posteriflow_tpu/models/long_bns.py. Three front ends:

  - v1, `multiband_tokens` (:37): the whitened FD strain mean-pooled in
    geometric bands, 2048 tokens of 6 channels (long_bns_v1);
  - v3, the chirp-adapted static heterodyne (:66-208): one fiducial
    TaylorF2 phase for the whole prior, then the variable-width pools of
    `build_chirp_token_grid`, 3 channels a detector plus 2 static
    features;
  - v4, the trigger-conditioned heterodyne (:376-597): each detector is
    multiplied by the conjugate TaylorF2+tidal phase at the detection
    trigger's chirp mass M̂c and arrival times t̂, then pooled into the
    variable-width tokens of a static grid (`build_trigger_token_grid`),
    3 channels a detector plus 2 static features (long_bns_v4).

The grid a v4 release was trained on is data. `build_trigger_token_grid`
sizes its pools by a greedy segmentation over the gradient of float32
phase differences near 1.6e4 rad, so its boundaries depend on the phase's
last bits; the port's float32 phase is not JAX's bit for bit. A release is
therefore served on the grid JAX built for it, stored under `grids/` and
named by `utils/provenance.config_hash` of its `tokens` config
(`load_stored_grid`); a trigger config with no stored grid raises. A v3
grid's pools follow float64 chirp times alone and rebuild from its
config.

The simulators are split into draws (`draw_long_bns`: θ from the BNS
prior, complex normal noise, the truncated-normal trigger errors) and a
deterministic apply step, as physics/simulator.py splits its own, so that
a test hands both packages the same draws. The encoder is JAX's
`LongBNSEncoder`; its float32 products run without TF32
(utils/precision.fp32_exact). Given the mesh's "model" group it runs
sequence-parallel (`make_sharded_encoder`, `make_sharded_nll`,
`make_sharded_nll_v4`): keys and values gathered, the pool averaged over
the group. The flow's spline runs the CUDA kernels of ops/rqs_cuda.py on
the card.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from posteriflow_torch.models.encoder import sinusoidal_positions
from posteriflow_torch.models.flow import CouplingNSF
from posteriflow_torch.parallel.mesh import (all_gather_seq, all_reduce_sum,
                                             shard_rows)
from posteriflow_torch.physics.constants import (MTSUN_SI, N_DETECTORS,
                                                 SAMPLE_RATE)
from posteriflow_torch.physics.detectors import OMEGA_EARTH, network_response
from posteriflow_torch.physics.projection import GMST_REF, project_to_network
from posteriflow_torch.physics.psd import default_network_psd
from posteriflow_torch.physics.waveforms.taylorf2 import (
    taylorf2_amp_phase, taylorf2_polarizations)
from posteriflow_torch.physics.waveforms.tidal import matter_effects
from posteriflow_torch.physics.whiten import whiten_fd
from posteriflow_torch.prior import PriorConfig, sample_signal_params
from posteriflow_torch.scaler import ParamScaler
from posteriflow_torch.utils.constants import device_constant
from posteriflow_torch.utils.logging import span
from posteriflow_torch.utils.precision import fp32_exact, gelu
from posteriflow_torch.utils.provenance import config_hash

EQM = 2.0 * 0.25 ** 0.6                 # Mc / m of an equal-mass binary
BNS_PRIOR = PriorConfig(type_probs=(0.0, 1.0, 0.0))
GRID_DIR = Path(__file__).resolve().parent / "grids"
# the arrays and scalars of a trigger grid that are stored; `freqs` is
# rebuilt from duration and cut
GRID_ARRAYS = ("starts", "ends", "counts", "epoch_cyc", "feat")
GRID_SCALARS = ("i_lo", "cut", "L", "n_tok", "duration", "sigma_mc_rel",
                "sigma_t", "trunc", "mc_lo", "mc_hi", "q_min")


def band_freqs(duration: float, f_hi: float) -> np.ndarray:
    """The rfft bins of a `duration`-s segment up to f_hi (inclusive of the
    first bin at or above it), float64."""
    freqs = np.fft.rfftfreq(int(duration * SAMPLE_RATE), 1.0 / SAMPLE_RATE)
    return freqs[:int(np.searchsorted(freqs, f_hi)) + 1]


# ── v1: multiband mean-pool ──────────────────────────────────────────────


def _band_indices(freqs: np.ndarray, f_lo: float, f_hi: float,
                  n_bands: int, per_band: int):
    """Per band, the bins it pools (padded with its last bin to a multiple
    of per_band), as long_bns.py:48-56 selects them."""
    edges = np.geomspace(f_lo, f_hi, n_bands + 1)
    out = []
    for b in range(n_bands):
        sel = np.where((freqs >= edges[b]) & (freqs < edges[b + 1]))[0]
        if len(sel) == 0:
            sel = np.array([int(np.argmin(np.abs(freqs - edges[b])))])
        n = int(math.ceil(len(sel) / per_band) * per_band)
        out.append(np.pad(sel, (0, n - len(sel)), mode="edge"))
    return out


def multiband_tokens(h_white_fd: torch.Tensor, freqs: np.ndarray,
                     f_lo: float = 20.0, f_hi: float = 1024.0,
                     n_bands: int = 64, per_band: int = 32) -> torch.Tensor:
    """Whitened FD strain [..., n_det, F] complex -> [..., L, n_det·2] real
    tokens, L = n_bands · per_band: each geomspaced band mean-pooled to
    per_band complex coefficients."""
    tokens = []
    for i, idx in enumerate(_band_indices(freqs, f_lo, f_hi, n_bands,
                                          per_band)):
        idx_t = device_constant(
            ("lbns_band", freqs.size, f_lo, f_hi, n_bands, per_band, i),
            h_white_fd.device, lambda idx=idx: torch.from_numpy(idx))
        band = h_white_fd[..., idx_t]                          # [..., D, n]
        band = band.reshape(*band.shape[:-1], per_band, -1)
        tokens.append(band.mean(dim=-1))                  # [..., D, per_band]
    tok = torch.cat(tokens, dim=-1).movedim(-1, -2)           # [..., L, D]
    return torch.cat([tok.real, tok.imag], dim=-1)


# ── v4: the trigger-conditioned heterodyne ───────────────────────────────


def _psi_f32(fb: torch.Tensor, m1, m2, chi) -> torch.Tensor:
    """TaylorF2 + tidal phase Ψ [F] in float32 at scalar masses (Python
    floats, as JAX's grid passes them) and equal spins chi."""
    t = torch.tensor
    return (taylorf2_amp_phase(fb, m1, m2, chi, chi, 100.0, 0.0)[1]
            + matter_effects(fb, t(m1, dtype=torch.float64),
                             t(m2, dtype=torch.float64))[0])


def _segment(spread_rad: np.ndarray, alpha: float) -> np.ndarray:
    """Greedy contiguous segmentation (long_bns.py:465-472): close a pool
    when the next bin would push its accumulated spread past alpha; a 1-bin
    pool is exact whatever its spread."""
    seg = np.zeros(len(spread_rad), np.int32)
    s, acc = 0, 0.0
    for j in range(len(spread_rad)):
        if acc > 0.0 and acc + spread_rad[j] > alpha:
            s += 1
            acc = 0.0
        seg[j] = s
        acc += spread_rad[j]
    return seg


def build_trigger_token_grid(duration: float = 64.0, f_lo: float = 20.0,
                             f_hi: float = 512.0, m_lo: float = 1.0,
                             m_hi: float = 2.5, q_min: float = 0.4,
                             chi_max: float = 0.05,
                             sigma_mc_rel: float = 5e-4,
                             sigma_t: float = 5e-3, trunc: float = 3.5,
                             alpha: float = 2.0,
                             pad_multiple: int = 64) -> dict:
    """The static token grid of the v4 heterodyne, as long_bns.py:399-507
    builds it: pools sized by the numerical group-delay spread of the
    residual phase over the residual prior, enveloped over the fiducial
    chirp mass, plus the ±trunc·σ_t timing slop; greedy segmentation to at
    most alpha rad a pool. The phases are float32 TaylorF2+tidal on the
    CPU (JAX pins its grid to its CPU backend), the segmentation float64
    numpy. A release is served on its stored grid, not on this one
    (`load_stored_grid`): the boundaries follow the phase's last bits."""
    import itertools
    freqs = band_freqs(duration, f_hi)
    cut = len(freqs)
    i_lo = int(np.searchsorted(freqs, f_lo))
    fb = freqs[i_lo:]
    df = float(freqs[1] - freqs[0])
    mc_lo, mc_hi = EQM * m_lo, EQM * m_hi
    fbt = torch.tensor(fb, dtype=torch.float32)

    def psi(m1, m2, chi):
        return _psi_f32(fbt, m1, m2, chi).numpy().astype(np.float64)

    def masses(mc, q):
        m1 = mc * (1.0 + q) ** 0.2 * q ** -0.6
        return m1, q * m1

    spread = np.zeros(len(fb))
    for mc_f in (mc_lo, 0.5 * (mc_lo + mc_hi), mc_hi):
        psi_f = psi(mc_f / EQM, mc_f / EQM, 0.0)
        taus = []
        for dmc, q, chi in itertools.product(
                (-trunc * sigma_mc_rel, trunc * sigma_mc_rel),
                (q_min, 1.0), (-chi_max, 0.0, chi_max)):
            m1, m2 = masses(mc_f * (1.0 + dmc), q)
            taus.append(np.gradient(psi(m1, m2, chi) - psi_f, fb)
                        / (2.0 * np.pi))
        taus = np.stack(taus)
        spread = np.maximum(spread, taus.max(0) - taus.min(0))
    spread += 2.0 * trunc * sigma_t
    seg = _segment(2.0 * np.pi * spread * df, alpha)
    n_tok = int(seg[-1]) + 1
    L = int(math.ceil(n_tok / pad_multiple) * pad_multiple)

    counts = np.maximum(np.bincount(seg, minlength=L).astype(np.float64),
                        1.0)
    ends = np.cumsum(np.bincount(seg, minlength=L)).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)
    epoch_cyc = np.mod(fb * (duration / 2.0), 1.0).astype(np.float32)
    f_cen = np.zeros(L)
    f_cen[:n_tok] = [fb[starts[t]:ends[t]].mean() if ends[t] > starts[t]
                     else f_lo for t in range(n_tok)]
    f_cen = np.maximum(f_cen, f_lo)
    feat = np.stack([np.log(f_cen / f_lo) / np.log(f_hi / f_lo),
                     np.log2(counts) / 10.0], axis=-1)
    return {
        "freqs": freqs, "i_lo": i_lo, "cut": cut, "L": L, "n_tok": n_tok,
        "starts": starts, "ends": ends, "counts": counts.astype(np.float32),
        "epoch_cyc": epoch_cyc, "feat": feat.astype(np.float32),
        "duration": duration, "sigma_mc_rel": sigma_mc_rel,
        "sigma_t": sigma_t, "trunc": trunc, "mc_lo": mc_lo, "mc_hi": mc_hi,
        "q_min": q_min,
        "config": trigger_grid_config(
            duration=duration, f_lo=f_lo, f_hi=f_hi, m_lo=m_lo, m_hi=m_hi,
            q_min=q_min, chi_max=chi_max, sigma_mc_rel=sigma_mc_rel,
            sigma_t=sigma_t, trunc=trunc, alpha=alpha,
            pad_multiple=pad_multiple),
    }


def trigger_grid_config(**kw) -> dict:
    """The `config` record of build_trigger_token_grid(**kw): "kind":
    "trigger" and every argument, defaults filled in, in the signature's
    order (what a run's calibration.json stores under "tokens")."""
    import inspect
    params = inspect.signature(build_trigger_token_grid).parameters
    unknown = set(kw) - set(params)
    if unknown:
        raise TypeError(f"unknown trigger grid arguments {sorted(unknown)}")
    return {"kind": "trigger",
            **{k: kw.get(k, p.default) for k, p in params.items()}}


def save_grid(grid: dict, path) -> Path:
    """Write a trigger grid's static arrays, scalars and config to an .npz
    (what `load_grid` reads)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, config=np.array(json.dumps(grid["config"],
                                              sort_keys=True)),
             **{k: np.asarray(grid[k]) for k in GRID_ARRAYS + GRID_SCALARS})
    return path


def load_grid(path) -> dict:
    """A trigger grid written by `save_grid`, with its `freqs` rebuilt."""
    with np.load(path) as z:
        cfg = json.loads(str(z["config"]))
        grid = {k: z[k] for k in GRID_ARRAYS}
        for k in GRID_SCALARS:
            v = z[k].item()
            grid[k] = v
    grid["config"] = cfg
    grid["freqs"] = band_freqs(cfg["duration"], cfg["f_hi"])
    if len(grid["freqs"]) != grid["cut"]:
        raise ValueError(f"grid {path}: {grid['cut']} bins stored, "
                         f"{len(grid['freqs'])} rebuilt from its config")
    return grid


def stored_grid_path(tok_cfg: dict) -> Path:
    """Where the grid JAX built for the tokens config `tok_cfg` is stored."""
    return GRID_DIR / f"trigger_{config_hash(tok_cfg)}.npz"


def load_stored_grid(tok_cfg: dict) -> dict:
    """The grid a release with tokens config `tok_cfg` was trained on.
    A "chirp" (v3) grid is rebuilt from its config, as JAX's validators
    rebuild it: its pools do not depend on float32 values. A trigger grid
    raises FileNotFoundError where none is stored: a rebuilt grid would
    not be the release's."""
    if tok_cfg.get("kind") == "chirp":
        return build_chirp_token_grid(
            **{k: v for k, v in tok_cfg.items() if k != "kind"})
    path = stored_grid_path(tok_cfg)
    if not path.is_file():
        raise FileNotFoundError(
            f"no stored trigger grid for tokens config {config_hash(tok_cfg)}"
            f" ({json.dumps(tok_cfg, sort_keys=True)}): a release is served "
            f"on the grid it was trained on, stored as {path}")
    grid = load_grid(path)
    if grid["config"] != tok_cfg:
        raise ValueError(f"{path} holds the grid of {grid['config']}, not "
                         f"of {tok_cfg}")
    return grid


def _grid_tensor(grid: dict, name: str, device) -> torch.Tensor:
    """A grid array on `device`, made once per grid and device."""
    cache = grid.setdefault("_tensors", {})
    key = (name, str(torch.device(device)))
    if key not in cache:
        if name == "fb":
            a = torch.tensor(grid["freqs"][grid["i_lo"]:], dtype=torch.float32)
        elif name in ("starts", "ends"):
            a = torch.from_numpy(np.asarray(grid[name], np.int64))
        elif name == "het":
            a = torch.from_numpy(np.asarray(grid[name], np.complex64))
        else:
            a = torch.from_numpy(np.asarray(grid[name], np.float32))
        cache[key] = a.to(device)
    return cache[key]


def pool_heterodyned(x: torch.Tensor, grid: dict) -> torch.Tensor:
    """Heterodyned banded strain [..., n_det, n] complex -> tokens
    [..., L, 3·n_det + 2] (long_bns.py:181 `_pool_heterodyned`): each
    segment pooled by a cumulative sum and a gather at its boundaries (no
    scatter); Re/Im of the pooled strain at unit noise variance, the excess
    energy a detector, then the 2 static features.

    The cumulative sums run in float64 (JAX's run in float32): the running
    sum of |x|² reaches ~6e4 over 31,489 bins, where a float32 step is
    4e-3, and a scan on the card rounds it otherwise than the CPU's
    sequential sum. The segment sums are rounded once to float32."""
    d = x.shape[-2]
    cols = torch.cat([x.real, x.imag, x.real ** 2 + x.imag ** 2], dim=-2)
    cs = torch.cumsum(cols.double(), dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    seg = (cs[..., _grid_tensor(grid, "ends", x.device)]
           - cs[..., _grid_tensor(grid, "starts", x.device)]).float()
    seg = seg.movedim(-2, -1)                                   # [..., L, 3D]
    k = _grid_tensor(grid, "counts", x.device)[:, None]
    coh = seg[..., :2 * d] / torch.sqrt(2.0 * k)
    energy = (seg[..., 2 * d:] - 2.0 * k) / (2.0 * torch.sqrt(k))
    feat = _grid_tensor(grid, "feat", x.device)
    return torch.cat([coh, energy, feat.expand(*seg.shape[:-2], -1, -1)],
                     dim=-1)


def trigger_phase(grid: dict, mc_hat: torch.Tensor) -> torch.Tensor:
    """The fiducial phase Ψ(M̂c) [..., n] over the grid's banded bins: the
    equal-mass TaylorF2+tidal phase at M̂c [...] (float32)."""
    fb = _grid_tensor(grid, "fb", mc_hat.device)
    m_hat = (mc_hat / EQM)[..., None]
    _, psi = taylorf2_amp_phase(fb, m_hat, m_hat, 0.0, 0.0, 100.0, 0.0)
    return psi + matter_effects(fb, m_hat, m_hat)[0]


def trigger_tokens(h_w: torch.Tensor, grid: dict, mc_hat: torch.Tensor,
                   t_hat: torch.Tensor,
                   psi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whitened FD strain [..., n_det, F_cut] + trigger (M̂c [...], t̂
    [..., n_det]) -> tokens [..., L, 3·n_det + 2] (long_bns.py:510): each
    detector heterodyned by the conjugate fiducial phase Ψ(M̂c) plus the
    known epoch duration/2 + t̂_d, in float32 mod-1 cycles. `psi` may be
    given in place of `trigger_phase(grid, mc_hat)`."""
    with span("pf.lbns.tokens"):
        if psi is None:
            psi = trigger_phase(grid, mc_hat)
        fb = _grid_tensor(grid, "fb", h_w.device)
        cyc = torch.remainder(fb * t_hat[..., None], 1.0)      # [..., D, n]
        phase = psi[..., None, :] + 2.0 * math.pi * (
            _grid_tensor(grid, "epoch_cyc", h_w.device) + cyc)
        het = torch.complex(torch.cos(phase), torch.sin(phase))
        return pool_heterodyned(h_w[..., grid["i_lo"]:] * het, grid)


# ── v3: the chirp-adapted static heterodyne ──────────────────────────────


def _tau_0pn(freqs: np.ndarray, mc: float) -> np.ndarray:
    """Newtonian time to merger [s] at GW frequency f for chirp mass mc."""
    return (5.0 / 256.0 * (np.pi * freqs) ** (-8.0 / 3.0)
            * (MTSUN_SI * mc) ** (-5.0 / 3.0))


def build_chirp_token_grid(duration: float = 64.0, f_lo: float = 20.0,
                           f_hi: float = 512.0, m_lo: float = 1.0,
                           m_hi: float = 2.5, t_off_max: float = 1.5,
                           alpha: float = 2.0,
                           pad_multiple: int = 64) -> dict:
    """The static token grid of the v3 front end (long_bns.py:73-178): one
    fiducial heterodyne for the whole (Mc, t_off) prior, the TaylorF2
    phase at the prior's t(f)-midpoint equal-mass chirp mass plus the
    epoch duration/2, and pools sized so that the worst-case residual
    phase spread a pool, 2π(Δt_chirp(f) + t_off_max)·Δf summed, stays
    within alpha rad (greedy, as `_segment`). The segmentation and the
    features are float64 numpy of the Newtonian chirp times and depend on
    no float32 value, so they are JAX's exactly; `het` carries the port's
    float32 TaylorF2 phase, computed on the CPU (JAX's is its own float32
    phase: the two differ in the last bits of Ψ)."""
    freqs = band_freqs(duration, f_hi)
    cut = len(freqs)
    i_lo = int(np.searchsorted(freqs, f_lo))
    fb = freqs[i_lo:]
    df = float(freqs[1] - freqs[0])
    mc_lo, mc_hi = EQM * m_lo, EQM * m_hi
    a_mid = 0.5 * (mc_lo ** (-5.0 / 3.0) + mc_hi ** (-5.0 / 3.0))
    mc_fid = float(a_mid ** (-0.6))
    m_fid = mc_fid / EQM

    dt_chirp = 0.5 * (_tau_0pn(fb, mc_lo) - _tau_0pn(fb, mc_hi))
    seg = _segment(2.0 * np.pi * (dt_chirp + t_off_max) * df, alpha)
    n_tok = int(seg[-1]) + 1
    L = int(math.ceil(n_tok / pad_multiple) * pad_multiple)
    counts = np.maximum(np.bincount(seg, minlength=L).astype(np.float64),
                        1.0)
    ends = np.cumsum(np.bincount(seg, minlength=L)).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int32)

    psi = taylorf2_amp_phase(torch.tensor(fb, dtype=torch.float32), m_fid,
                             m_fid, 0.0, 0.0, 100.0, 0.0)[1]
    psi = psi.numpy().astype(np.float64)
    epoch_cyc = np.mod(fb * (duration / 2.0), 1.0)
    het = np.exp(1j * (psi + 2.0 * np.pi * epoch_cyc)).astype(np.complex64)

    f_cen = np.zeros(L)
    f_cen[:n_tok] = [fb[starts[t]:ends[t]].mean() if ends[t] > starts[t]
                     else f_lo for t in range(n_tok)]
    f_cen = np.maximum(f_cen, f_lo)
    feat = np.stack([np.log(f_cen / f_lo) / np.log(f_hi / f_lo),
                     np.log2(counts) / 10.0], axis=-1)
    return {
        "freqs": freqs, "i_lo": i_lo, "cut": cut, "L": L, "n_tok": n_tok,
        "starts": starts, "ends": ends, "counts": counts.astype(np.float32),
        "het": het, "feat": feat.astype(np.float32),
        "mc_fid": mc_fid, "m_fid": m_fid, "duration": duration,
        "config": {"kind": "chirp", "duration": duration, "f_lo": f_lo,
                   "f_hi": f_hi, "m_lo": m_lo, "m_hi": m_hi,
                   "t_off_max": t_off_max, "alpha": alpha,
                   "pad_multiple": pad_multiple},
    }


def chirp_tokens(h_w: torch.Tensor, grid: dict) -> torch.Tensor:
    """Whitened FD strain [..., n_det, F_cut] -> the v3 tokens
    [..., L, 3·n_det + 2] (long_bns.py:204): the banded bins times the
    grid's static heterodyne, pooled as `pool_heterodyned` pools."""
    het = _grid_tensor(grid, "het", h_w.device)
    return pool_heterodyned(h_w[..., grid["i_lo"]:] * het, grid)


def chirp_mass(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """(m1·m2)^0.6·(m1 + m2)^-0.2 through float64, rounded once to the
    inputs' dtype. A float32 pow may be an ulp off, and differently so on
    the CPU and the card; the trigger-relative label divides the chirp
    mass's error by 2.5e-3, so one ulp moves a trained density by up to a
    tenth of a nat."""
    a, b = m1.double(), m2.double()
    return ((a * b) ** 0.6 * (a + b) ** -0.2).to(m1.dtype)


# ── simulators: draws, then a deterministic apply ─────────────────────────


class LongBNSDraws(NamedTuple):
    """The random draws of a long-BNS batch of B events."""
    theta: torch.Tensor           # [B, 11] physical, from the BNS prior
    noise: torch.Tensor           # [B, n_det, F] complex64, E|n|² = 2
    eps: Optional[torch.Tensor]   # [B, 1 + n_det] trigger errors, |ε| <= trunc


def draw_long_bns(batch: int, n_freqs: int, trunc: Optional[float] = 3.5,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> LongBNSDraws:
    """θ from PriorConfig(type_probs=(0, 1, 0)), complex normal noise
    [B, n_det, n_freqs] and, unless trunc is None (v1), the trigger errors:
    standard normals truncated to ±trunc, by the inverse CDF."""
    theta = sample_signal_params((batch,), BNS_PRIOR, generator, device)
    shape = (batch, N_DETECTORS, n_freqs)
    noise = torch.complex(
        torch.randn(shape, generator=generator, device=device),
        torch.randn(shape, generator=generator, device=device))
    eps = None
    if trunc is not None:
        lo = 0.5 * math.erfc(trunc / math.sqrt(2.0))            # Φ(-trunc)
        u = torch.rand((batch, 1 + N_DETECTORS), generator=generator,
                       device=device, dtype=torch.float64)
        p = lo + u * (1.0 - 2.0 * lo)
        eps = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(
            -trunc, trunc).float()
    return LongBNSDraws(theta, noise, eps)


def _asd(freqs: np.ndarray, device) -> torch.Tensor:
    """The design network ASD [n_det, F] over `freqs`, in scaled units."""
    return device_constant(
        ("lbns_asd", freqs.size, float(freqs[1])), device,
        lambda: torch.tensor(np.sqrt(default_network_psd(freqs)) * 1e23,
                             dtype=torch.float32))


def white_signal(theta: torch.Tensor, freqs: np.ndarray,
                 duration: float) -> torch.Tensor:
    """Whitened FD signal [B, n_det, F] complex64 of θ [B, 11] (the body of
    long_bns.py's `one`): TaylorF2 polarizations times the matter taper
    and tidal phase, projected with the epoch duration/2, whitened by the
    design ASD."""
    dev = theta.device
    f = device_constant(("lbns_freqs", freqs.size, float(freqs[1])), dev,
                        lambda: torch.tensor(freqs, dtype=torch.float32))
    c = [t[:, None] for t in theta.unbind(-1)]
    m1, m2, dist, ra, dec, tj, psi_a, ph, t_off, a1, a2 = c
    hp, hc = taylorf2_polarizations(f, m1, m2, a1, a2, dist, tj, ph)
    psi_t, taper = matter_effects(f, m1, m2)
    fac = torch.complex(taper * torch.cos(psi_t), taper * -torch.sin(psi_t))
    h_det = project_to_network(f, hp * fac, hc * fac, ra[:, 0], dec[:, 0],
                               psi_a[:, 0], t_off[:, 0], duration=duration)
    return whiten_fd(h_det, _asd(freqs, dev)[None], 1.0 / duration)


def trigger_of(theta: torch.Tensor, eps: torch.Tensor,
               grid: dict) -> torch.Tensor:
    """The detection trigger [B, 1 + n_det] = (M̂c, t̂_1..t̂_D): the truth
    (chirp mass, geocentric time plus each detector's delay) moved by the
    errors ε scaled by σ_mc_rel and σ_t."""
    m1, m2, ra, dec, psi_a, t_off = (theta[:, i] for i in (0, 1, 3, 4, 6, 8))
    mc = chirp_mass(m1, m2)
    _, _, dt = network_response(ra, dec, psi_a, GMST_REF + OMEGA_EARTH * t_off)
    mc_hat = mc * (1.0 + grid["sigma_mc_rel"] * eps[:, 0])
    t_hat = t_off[:, None] + dt + grid["sigma_t"] * eps[:, 1:]
    return torch.cat([mc_hat[:, None], t_hat], dim=-1)


def simulate_long_bns_v4_from_draws(draws: LongBNSDraws, grid: dict,
                                    amp_scale: float = 1.0):
    """long_bns.py:537 `simulate_long_bns_batch_v4` on given draws ->
    (tokens [B, L, 3·n_det + 2], θ [B, 11], trig [B, 1 + n_det]).
    amp_scale rescales the signal: 0 gives the noise-only tokens of the
    same θ, trigger and noise."""
    h_w = white_signal(draws.theta, grid["freqs"], grid["duration"])
    trig = trigger_of(draws.theta, draws.eps, grid)
    tok = trigger_tokens(amp_scale * h_w + draws.noise, grid, trig[:, 0],
                         trig[:, 1:])
    return tok, draws.theta, trig


def simulate_long_bns_batch_v4(batch: int, grid: dict,
                               amp_scale: float = 1.0,
                               generator: Optional[torch.Generator] = None,
                               device="cuda"):
    """A v4 training batch: `draw_long_bns`, then the apply step."""
    draws = draw_long_bns(batch, grid["cut"], grid["trunc"], generator,
                          device)
    return simulate_long_bns_v4_from_draws(draws, grid, amp_scale)


def simulate_long_bns_v3_from_draws(draws: LongBNSDraws, grid: dict):
    """long_bns.py:333 `simulate_long_bns_batch_v3` on given draws (no
    trigger errors) -> (tokens [B, L, 3·n_det + 2], θ [B, 11]): the v1
    waveform and noise model, tokenized by `chirp_tokens`."""
    h_w = white_signal(draws.theta, grid["freqs"], grid["duration"])
    return chirp_tokens(h_w + draws.noise, grid), draws.theta


def simulate_long_bns_batch_v3(batch: int, grid: dict,
                               generator: Optional[torch.Generator] = None,
                               device="cuda"):
    """A v3 training batch: draws (no trigger), then the apply step."""
    draws = draw_long_bns(batch, grid["cut"], None, generator, device)
    return simulate_long_bns_v3_from_draws(draws, grid)


def simulate_long_bns_from_draws(draws: LongBNSDraws, duration: float = 64.0,
                                 n_bands: int = 64, per_band: int = 32,
                                 f_hi: float = 1024.0):
    """long_bns.py:274 `simulate_long_bns_batch` (v1) on given draws ->
    (tokens [B, n_bands·per_band, 2·n_det], θ [B, 11])."""
    freqs = band_freqs(duration, f_hi)
    h_w = white_signal(draws.theta, freqs, duration)
    tok = multiband_tokens(h_w + draws.noise, freqs, n_bands=n_bands,
                           per_band=per_band, f_hi=f_hi)
    return tok, draws.theta


def simulate_long_bns_batch(batch: int, duration: float = 64.0,
                            n_bands: int = 64, per_band: int = 32,
                            f_hi: float = 1024.0,
                            generator: Optional[torch.Generator] = None,
                            device="cuda"):
    """A v1 training batch: draws (no trigger), then the apply step."""
    draws = draw_long_bns(batch, band_freqs(duration, f_hi).size, None,
                          generator, device)
    return simulate_long_bns_from_draws(draws, duration, n_bands, per_band,
                                        f_hi)


# ── labels and trigger features ──────────────────────────────────────────


class TriggerScaler:
    """Trigger-relative labels θ [.., 11] + trig [.., 1 + D] <-> y
    (long_bns.py:600): y_mc = (Mc − M̂c)/(k·σ_mc·M̂c), y_q linear in q over
    [q_min, 1], y_t = (t_off − mean t̂)/t_scale; the other 8 parameters
    keep ParamScaler's map."""

    def __init__(self, sigma_mc_rel: float = 5e-4, sigma_t: float = 5e-3,
                 trunc: float = 3.5, q_min: float = 0.4,
                 t_scale: float = 0.04, mc_scale_sigmas: float = 5.0):
        self.base = ParamScaler()
        self.s_mc = mc_scale_sigmas * sigma_mc_rel
        self.q_min = q_min
        self.t_scale = t_scale

    @staticmethod
    def _split_trig(trig: torch.Tensor):
        return trig[..., 0], torch.mean(trig[..., 1:], dim=-1)

    @staticmethod
    def _set(y: torch.Tensor, c0, c1, c8) -> torch.Tensor:
        """y with columns 0, 1 and 8 replaced (out of place)."""
        return torch.cat([c0[..., None], c1[..., None], y[..., 2:8],
                          c8[..., None], y[..., 9:]], dim=-1)

    def normalize(self, theta: torch.Tensor,
                  trig: torch.Tensor) -> torch.Tensor:
        y = self.base.normalize(theta)
        m1, m2 = theta[..., 0], theta[..., 1]
        mc_hat, t_ref = self._split_trig(trig)
        mc = chirp_mass(m1, m2)
        y_mc = (mc - mc_hat) / (self.s_mc * mc_hat)
        y_q = 2.0 * (m2 / m1 - self.q_min) / (1.0 - self.q_min) - 1.0
        y_t = (theta[..., 8] - t_ref) / self.t_scale
        return self._set(y, y_mc, y_q, y_t)

    def denormalize(self, y: torch.Tensor,
                    trig: torch.Tensor) -> torch.Tensor:
        y = self.base.wrap(y)
        th = self.base.denormalize(y)
        mc_hat, t_ref = self._split_trig(trig)
        mc = mc_hat * (1.0 + self.s_mc * y[..., 0])
        q = self.q_min + 0.5 * (y[..., 1] + 1.0) * (1.0 - self.q_min)
        m1 = mc * (1.0 + q) ** 0.2 * q ** -0.6
        t_off = t_ref + self.t_scale * y[..., 8]
        return self._set(th, m1, q * m1, t_off)


def trigger_features(trig: torch.Tensor, mc_lo: float,
                     mc_hi: float) -> torch.Tensor:
    """Context features [.., 2 + D] of the trigger [.., 1 + D]: log-scaled
    M̂c, the relative arrival pattern and the window position."""
    mc_hat = trig[..., 0]
    th = trig[..., 1:]
    tbar = torch.mean(th, dim=-1, keepdim=True)
    f_mc = (2.0 * (torch.log(mc_hat) - math.log(mc_lo))
            / (math.log(mc_hi) - math.log(mc_lo)) - 1.0)
    return torch.cat([f_mc[..., None], (th - tbar) / 0.02, tbar / 1.6],
                     dim=-1)


# ── encoder and models ───────────────────────────────────────────────────


class SeqParallelAttention(nn.Module):
    """long_bns.py:211: exact multi-head attention, written as JAX's einsum
    and softmax (the logits divided by sqrt(head_dim)). The q/k/v/o
    DenseGeneral kernels are carried into nn.Linear. With `seq_group` (the
    mesh's "model" group) x is this rank's slice of the sequence: the
    queries stay local and the keys and values are gathered over the
    group, differentiably; without one it is plain attention."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(d_model, d_model))

    def forward(self, x: torch.Tensor, seq_group=None) -> torch.Tensor:
        b, l, dm = x.shape
        h = self.n_heads
        dh = dm // h
        q = self.q(x).view(b, l, h, dh)
        k = self.k(x).view(b, l, h, dh)
        v = self.v(x).view(b, l, h, dh)
        if seq_group is not None:
            k = all_gather_seq(k, seq_group, dim=1)
            v = all_gather_seq(v, seq_group, dim=1)
        a = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
        w = torch.exp(a - torch.amax(a, dim=-1, keepdim=True))
        w = w / torch.sum(w, dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.o(o.reshape(b, l, dm))


class LongBNSEncoder(nn.Module):
    """Tokens [B, L, n_feat] -> context [B, context_dim] (long_bns.py:235):
    a non-overlapping patch embedding, sinusoidal positions, n_layers
    pre-LayerNorm blocks (flax's eps 1e-6, tanh GELU, feed-forward 2×),
    a mean over the sequence and the `out` projection. Float32, without
    TF32. Module names are the flax tree's (LayerNorm_0 ... auto-named in
    call order: two a layer).

    With `seq_group` the tokens are this rank's slice of the sequence
    (the group's ranks hold consecutive slices of equal length): the
    slice takes its own positions, attention gathers the keys and values,
    and the mean is the group's (JAX's pmean)."""

    def __init__(self, n_feat: int, d_model: int = 128, n_layers: int = 4,
                 n_heads: int = 8, context_dim: int = 256, patch: int = 1):
        super().__init__()
        self.d_model = d_model
        self.n_layers = n_layers
        self.patch = patch
        self.embed = nn.Linear(patch * n_feat, d_model)
        for i in range(n_layers):
            self.add_module(f"LayerNorm_{2 * i}",
                            nn.LayerNorm(d_model, eps=1e-6))
            self.add_module(f"attn_{i}",
                            SeqParallelAttention(d_model, n_heads))
            self.add_module(f"LayerNorm_{2 * i + 1}",
                            nn.LayerNorm(d_model, eps=1e-6))
            self.add_module(f"ff1_{i}", nn.Linear(d_model, 2 * d_model))
            self.add_module(f"ff2_{i}", nn.Linear(2 * d_model, d_model))
        self.out = nn.Linear(d_model, context_dim)

    def positions(self, n: int, device) -> torch.Tensor:
        return device_constant(("lbns_pos", n, self.d_model), device,
                               lambda: torch.from_numpy(
                                   sinusoidal_positions(n, self.d_model)))

    def forward(self, tokens: torch.Tensor, seq_group=None) -> torch.Tensor:
        with span("pf.lbns.encoder"):
            b, lt, ft = tokens.shape
            if self.patch > 1:
                tokens = tokens.reshape(b, lt // self.patch, self.patch * ft)
            n = tokens.shape[1]
            if seq_group is None:
                pos = self.positions(n, tokens.device)
            else:
                i = dist.get_rank(seq_group)
                pos = self.positions(n * dist.get_world_size(seq_group),
                                     tokens.device)[i * n:(i + 1) * n]
            with fp32_exact():
                h = self.embed(tokens) + pos
                for i in range(self.n_layers):
                    ln_a = getattr(self, f"LayerNorm_{2 * i}")
                    ln_f = getattr(self, f"LayerNorm_{2 * i + 1}")
                    h = h + getattr(self, f"attn_{i}")(ln_a(h), seq_group)
                    f = getattr(self, f"ff1_{i}")(ln_f(h))
                    h = h + getattr(self, f"ff2_{i}")(gelu(f))
                pooled = torch.mean(h, dim=1)
                if seq_group is not None:
                    pooled = (all_reduce_sum(pooled, seq_group)
                              / dist.get_world_size(seq_group))
                return self.out(pooled)


class LongBNSNPEv4(nn.Module):
    """The v4 model (long_bns.py:662): trigger-heterodyned tokens ->
    LongBNSEncoder, its context joined by the trigger features -> a
    coupling flow over the trigger-relative labels."""

    def __init__(self, enc: Optional[dict] = None, flow_layers: int = 6,
                 flow_hidden: int = 128, flow_bins: int = 12,
                 mc_lo: float = EQM, mc_hi: float = 2.5 * EQM,
                 sigma_mc_rel: float = 5e-4, sigma_t: float = 5e-3,
                 trunc: float = 3.5, q_min: float = 0.4):
        super().__init__()
        cfg = dict(enc or {})
        self.mc_lo, self.mc_hi = mc_lo, mc_hi
        self.encoder = LongBNSEncoder(n_feat=3 * N_DETECTORS + 2, **cfg)
        ctx = cfg.get("context_dim", 256)
        self.flow = CouplingNSF(features=11,
                                context_features=ctx + 2 + N_DETECTORS,
                                num_layers=flow_layers, hidden=flow_hidden,
                                num_bins=flow_bins)
        self.scaler = TriggerScaler(sigma_mc_rel, sigma_t, trunc, q_min)

    def context(self, tokens: torch.Tensor,
                trig: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.encoder(tokens),
                          trigger_features(trig, self.mc_lo, self.mc_hi)],
                         dim=-1)

    def forward(self, tokens: torch.Tensor, theta: torch.Tensor,
                trig: torch.Tensor) -> torch.Tensor:
        """tokens [B, L, F]; θ [B, 11] physical; trig [B, 1 + D] -> the
        mean NLL."""
        y = self.scaler.normalize(theta, trig)
        return -torch.mean(self.flow.log_prob(y, self.context(tokens, trig)))

    def sample_raw(self, tokens: torch.Tensor, trig: torch.Tensor,
                   n_samples: int = 128,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None):
        """-> (physical draws [B, n, 11], raw normalized draws y [B, n, 11]
        before the wrap). Base draws z [B, n, 11] from `generator` unless
        given."""
        with span("pf.lbns.sample"):
            ctx = self.context(tokens, trig)
            if z is None:
                z = torch.randn((ctx.shape[0], n_samples, 11),
                                generator=generator, device=ctx.device)
            y, _ = self.flow.sample_with_log_prob(z, ctx[:, None, :])
            return self.scaler.denormalize(y, trig[:, None, :]), y

    def sample(self, tokens: torch.Tensor, trig: torch.Tensor,
               n_samples: int = 128,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample_raw(tokens, trig, n_samples, generator, z)[0]


class LongBNSNPE(nn.Module):
    """The v1 and v3 model (long_bns.py:717): tokens -> LongBNSEncoder ->
    a coupling flow over ParamScaler's labels. n_feat is the tokens'
    channels (flax infers it from the first batch): 2·n_det for v1's
    multiband tokens, 3·n_det + 2 for v3's chirp tokens."""

    def __init__(self, enc: Optional[dict] = None, flow_layers: int = 6,
                 flow_hidden: int = 128, flow_bins: int = 8,
                 n_feat: int = 2 * N_DETECTORS):
        super().__init__()
        cfg = dict(enc or {})
        self.encoder = LongBNSEncoder(n_feat=n_feat, **cfg)
        self.flow = CouplingNSF(features=11,
                                context_features=cfg.get("context_dim", 256),
                                num_layers=flow_layers, hidden=flow_hidden,
                                num_bins=flow_bins)
        self.scaler = ParamScaler()

    def forward(self, tokens: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
        """tokens [B, L, F]; θ [B, 11] physical -> the mean NLL."""
        y = self.scaler.normalize(theta)
        return -torch.mean(self.flow.log_prob(y, self.encoder(tokens)))

    def sample_raw(self, tokens: torch.Tensor, n_samples: int = 128,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None):
        """-> (physical draws [B, n, 11], raw normalized draws y)."""
        ctx = self.encoder(tokens)
        if z is None:
            z = torch.randn((ctx.shape[0], n_samples, 11),
                            generator=generator, device=ctx.device)
        y, _ = self.flow.sample_with_log_prob(z, ctx[:, None, :])
        return self.scaler.denormalize(self.scaler.wrap(y)), y

    def sample(self, tokens: torch.Tensor, n_samples: int = 128,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample_raw(tokens, n_samples, generator, z)[0]


# ── sequence parallelism ─────────────────────────────────────────────────


def _sharded_context(mesh, seq_len: int, patch: int):
    """encode(encoder, tokens [B, L, F]) -> this rank's rows along "data"
    of the context [B / n_data, C], its slice along "model" of the
    sequence through the encoder with the "model" group (long_bns.py:
    846-863). Raises as JAX does when a slice does not divide by the
    patch."""
    group = mesh.get_group("model")
    l_loc = seq_len // mesh["model"].size()
    if l_loc % patch:
        raise ValueError(f"seq_len/n_shards={l_loc} not divisible by "
                         f"patch={patch}")

    def encode(encoder: LongBNSEncoder, tokens: torch.Tensor):
        if tokens.shape[1] != seq_len:
            raise ValueError(f"tokens of length {tokens.shape[1]}, the "
                             f"encoder was sharded for {seq_len}")
        rows = shard_rows(tokens.shape[0], mesh, "data")
        cols = shard_rows(seq_len, mesh, "model")
        return encoder(tokens[rows, cols], group)

    return encode


def make_sharded_encoder(mesh, seq_len: int, n_feat: int,
                         cfg: Optional[dict] = None):
    """(init_fn, apply_fn, apply_unsharded) for the sequence-parallel
    encoder (long_bns.py:829). init_fn(generator=None) -> a LongBNSEncoder
    of cfg with flax's initial distribution (the parameters: the same
    module serves sharded and unsharded). apply_fn(encoder, tokens
    [B, L, n_feat]) -> [B, context_dim] on every rank: each rank encodes
    its block (rows along "data", its slice of L along "model"), and the
    rows are gathered over "data", differentiably. apply_unsharded is the
    plain module."""
    from posteriflow_torch.train.trainer import init_params
    cfg = dict(cfg or {})
    encode = _sharded_context(mesh, seq_len, cfg.get("patch", 1))
    data = mesh.get_group("data")

    def init_fn(generator: Optional[torch.Generator] = None):
        return init_params(LongBNSEncoder(n_feat=n_feat, **cfg), generator)

    def apply_fn(encoder: LongBNSEncoder, tokens: torch.Tensor):
        return all_gather_seq(encode(encoder, tokens), data, dim=0)

    def apply_unsharded(encoder: LongBNSEncoder, tokens: torch.Tensor):
        return encoder(tokens)

    return init_fn, apply_fn, apply_unsharded


def _sharded_mean(nll: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's mean NLL from this rank's mean over its rows,
    differentiable as this rank's share of it. Every rank of a "model"
    group holds the same rows, so the loss is replicated over the group;
    each rank backpropagates nll / (n_data · n_model), and the group's
    collectives carry every rank's share into every copy of the encoder:
    summing the parameters' gradients over all ranks then gives the
    unsharded gradient, counting the replicated loss once. The value is
    the mean over "data" of the ranks' means (equal rows a rank)."""
    n_data, n_model = mesh["data"].size(), mesh["model"].size()
    share = nll / (n_data * n_model)
    value = all_reduce_sum(nll.detach(), mesh.get_group("data")) / n_data
    return share + (value - share).detach()


def make_sharded_nll(mesh, seq_len: int, npe: "LongBNSNPE"):
    """The sequence-parallel training loss of LongBNSNPE (long_bns.py:765):
    loss_fn(model, tokens [B, L, F], θ [B, 11]) -> the global batch's mean
    NLL, the encoder sharded as make_sharded_encoder shards it, the flow
    on this rank's rows. `model` is an LongBNSNPE of npe's configuration
    (npe itself, typically): its parameters are the unsharded model's, so
    checkpoints interchange. Every rank passes the whole batch. After
    loss.backward(), sum the parameters' gradients over all ranks
    (parallel/mesh.all_reduce_grads with the default group): that is the
    unsharded loss's gradient."""
    encode = _sharded_context(mesh, seq_len, npe.encoder.patch)

    def loss_fn(model: "LongBNSNPE", tokens: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
        rows = shard_rows(tokens.shape[0], mesh, "data")
        ctx = encode(model.encoder, tokens)
        y = model.scaler.normalize(theta[rows])
        return _sharded_mean(-torch.mean(model.flow.log_prob(y, ctx)), mesh)

    return loss_fn


def make_sharded_nll_v4(mesh, seq_len: int, npe: "LongBNSNPEv4"):
    """make_sharded_nll for LongBNSNPEv4 (long_bns.py:799): loss_fn(model,
    tokens, θ, trig [B, 1 + D]); the sharded context joined by this rank's
    rows of the trigger features, the labels trigger-relative."""
    encode = _sharded_context(mesh, seq_len, npe.encoder.patch)

    def loss_fn(model: "LongBNSNPEv4", tokens: torch.Tensor,
                theta: torch.Tensor, trig: torch.Tensor) -> torch.Tensor:
        rows = shard_rows(tokens.shape[0], mesh, "data")
        ctx = torch.cat([encode(model.encoder, tokens),
                         trigger_features(trig[rows], model.mc_lo,
                                          model.mc_hi)], dim=-1)
        y = model.scaler.normalize(theta[rows], trig[rows])
        return _sharded_mean(-torch.mean(model.flow.log_prob(y, ctx)), mesh)

    return loss_fn


# ── configuration ────────────────────────────────────────────────────────


def model_config(cal_cfg: dict) -> dict:
    """The `config` of a run's calibration.json -> {"v4": bool, "kind",
    "enc", "tokens", "flow_bins"}, as scripts/validate_long_bns.py:102-118
    reads it: the nested enc/tokens dicts verbatim, the flat keys for
    older calibrations, tokens {"kind": "v1"} where none is recorded;
    "kind" is the tokens' kind (v1, chirp for v3, trigger for v4)."""
    enc = cal_cfg.get("enc") or {k: cal_cfg[k] for k in ("d_model",
                                                         "n_layers")
                                 if k in cal_cfg}
    tok = cal_cfg.get("tokens", {"kind": "v1"})
    kind = tok.get("kind")
    return {"v4": kind == "trigger", "kind": kind, "enc": dict(enc),
            "tokens": dict(tok),
            "flow_bins": cal_cfg.get("flow", {}).get("bins", 12)}


def build_model(cal_cfg: dict) -> nn.Module:
    """The model a calibration.json's config describes (weights not
    loaded): LongBNSNPEv4 for trigger tokens, else LongBNSNPE at its
    default 8 bins (JAX's scripts build it so for v1 and v3 alike, whatever
    the config's flow bins) over 6 (v1) or 3·n_det + 2 (v3) features."""
    mc = model_config(cal_cfg)
    if mc["v4"]:
        tok = mc["tokens"]
        return LongBNSNPEv4(enc=mc["enc"], flow_bins=mc["flow_bins"],
                            sigma_mc_rel=tok["sigma_mc_rel"],
                            sigma_t=tok["sigma_t"])
    n_feat = 3 * N_DETECTORS + 2 if mc["kind"] == "chirp" else 2 * N_DETECTORS
    return LongBNSNPE(enc=mc["enc"], n_feat=n_feat)
