"""Long-duration BNS NPE v4 (torch): 64-s binary-neutron-star inspirals,
the trigger-conditioned heterodyne front end of the long_bns_v4 release.

Each detector is multiplied by the conjugate TaylorF2+tidal phase at the
detection trigger's chirp mass M̂c and arrival times t̂, then pooled into
the variable-width tokens of a static grid, 3 channels a detector plus 2
static features (`trigger_tokens`).

The grid a release was trained on is data: its pools were sized from
float32 phase differences, so a rebuilt grid would not be the release's.
It is stored under `grids/`, named by `utils/provenance.config_hash` of
its `tokens` config (`load_stored_grid`); a config with no stored grid
raises.

The simulator is split into draws (`draw_long_bns`: θ from the BNS prior,
complex normal noise, the truncated-normal trigger errors) and the
deterministic `white_signal` and `trigger_of`. The encoder is
`LongBNSEncoder`; its float32 products run without TF32
(utils/precision.fp32_exact). The flow's spline is the plain one.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from pfbench.reference.frozen.models.encoder import sinusoidal_positions
from pfbench.reference.frozen.models.flow import CouplingNSF, gelu
from pfbench.reference.frozen.physics.constants import N_DETECTORS, SAMPLE_RATE
from pfbench.reference.frozen.physics.detectors import OMEGA_EARTH, network_response
from pfbench.reference.frozen.physics.projection import GMST_REF, project_to_network
from pfbench.reference.frozen.physics.psd import default_network_psd
from pfbench.reference.frozen.physics.waveforms.taylorf2 import (
    taylorf2_amp_phase, taylorf2_polarizations)
from pfbench.reference.frozen.physics.waveforms.tidal import matter_effects
from pfbench.reference.frozen.physics.whiten import whiten_fd
from pfbench.reference.frozen.prior import PriorConfig, sample_signal_params
from pfbench.reference.frozen.scaler import ParamScaler
from pfbench.reference.frozen.utils.constants import device_constant
from pfbench.reference.frozen.utils.precision import fp32_exact
from pfbench.reference.frozen.utils.provenance import config_hash

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


# ── v4: the trigger-conditioned heterodyne ───────────────────────────────


def load_grid(path) -> dict:
    """A stored trigger grid, with its `freqs` rebuilt."""
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
    """The grid a release with tokens config `tok_cfg` was trained on;
    FileNotFoundError where none is stored: a rebuilt grid would not be
    the release's."""
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
    if psi is None:
        psi = trigger_phase(grid, mc_hat)
    fb = _grid_tensor(grid, "fb", h_w.device)
    cyc = torch.remainder(fb * t_hat[..., None], 1.0)          # [..., D, n]
    phase = psi[..., None, :] + 2.0 * math.pi * (
        _grid_tensor(grid, "epoch_cyc", h_w.device) + cyc)
    het = torch.complex(torch.cos(phase), torch.sin(phase))
    return pool_heterodyned(h_w[..., grid["i_lo"]:] * het, grid)


# ── v3: the chirp-adapted static heterodyne ──────────────────────────────


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


class Attention(nn.Module):
    """long_bns.py:211: exact multi-head attention, written as JAX's einsum
    and softmax (the logits divided by sqrt(head_dim)). The q/k/v/o
    DenseGeneral kernels are carried into nn.Linear."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        for name in ("q", "k", "v", "o"):
            self.add_module(name, nn.Linear(d_model, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, dm = x.shape
        h = self.n_heads
        dh = dm // h
        q = self.q(x).view(b, l, h, dh)
        k = self.k(x).view(b, l, h, dh)
        v = self.v(x).view(b, l, h, dh)
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
    call order: two a layer)."""

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
                            Attention(d_model, n_heads))
            self.add_module(f"LayerNorm_{2 * i + 1}",
                            nn.LayerNorm(d_model, eps=1e-6))
            self.add_module(f"ff1_{i}", nn.Linear(d_model, 2 * d_model))
            self.add_module(f"ff2_{i}", nn.Linear(2 * d_model, d_model))
        self.out = nn.Linear(d_model, context_dim)

    def positions(self, n: int, device) -> torch.Tensor:
        return device_constant(("lbns_pos", n, self.d_model), device,
                               lambda: torch.from_numpy(
                                   sinusoidal_positions(n, self.d_model)))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, lt, ft = tokens.shape
        if self.patch > 1:
            tokens = tokens.reshape(b, lt // self.patch, self.patch * ft)
        n = tokens.shape[1]
        pos = self.positions(n, tokens.device)
        with fp32_exact():
            h = self.embed(tokens) + pos
            for i in range(self.n_layers):
                ln_a = getattr(self, f"LayerNorm_{2 * i}")
                ln_f = getattr(self, f"LayerNorm_{2 * i + 1}")
                h = h + getattr(self, f"attn_{i}")(ln_a(h))
                f = getattr(self, f"ff1_{i}")(ln_f(h))
                h = h + getattr(self, f"ff2_{i}")(gelu(f))
            return self.out(torch.mean(h, dim=1))


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

    def sample_raw(self, tokens: torch.Tensor, trig: torch.Tensor,
                   n_samples: int = 128,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None):
        """-> (physical draws [B, n, 11], raw normalized draws y [B, n, 11]
        before the wrap). Base draws z [B, n, 11] from `generator` unless
        given."""
        ctx = self.context(tokens, trig)
        if z is None:
            z = torch.randn((ctx.shape[0], n_samples, 11),
                            generator=generator, device=ctx.device)
        y, _ = self.flow.sample_with_log_prob(z, ctx[:, None, :])
        return self.scaler.denormalize(y, trig[:, None, :]), y

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
    """The LongBNSNPEv4 that a calibration.json's config of trigger
    tokens describes (weights not loaded)."""
    mc = model_config(cal_cfg)
    if not mc["v4"]:
        raise ValueError(f"not a v4 (trigger tokens) config: {mc['kind']}")
    tok = mc["tokens"]
    return LongBNSNPEv4(enc=mc["enc"], flow_bins=mc["flow_bins"],
                        sigma_mc_rel=tok["sigma_mc_rel"],
                        sigma_t=tok["sigma_t"])
