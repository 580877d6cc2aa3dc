"""PriorityNet: the learned extraction-order scorer for overlapping
candidates (torch).

Port of posteriflow_tpu/models/priority_net.py. Per candidate: a strided
conv stack over a 0.5 s whitened strain segment around its merger, the
physics features of its parameters, and (by flag) excess-power features,
the physics expected SNR and time-crowding features; self-attention over
the candidates of an event; a priority head, a Softplus uncertainty head
and an affine calibration. What the flax module implies and the port
writes out:

  - GELU is the tanh approximation and LayerNorm's epsilon is 1e-6;
  - the conv is channel-last VALID with stride 4 over [B, n]: here a
    Conv1d over [B·n, 3, SEG_LEN];
  - the attention mask fills excluded logits with float32's most negative
    finite value, so a dead candidate slot (all keys masked) attends
    uniformly and stays finite;
  - module and parameter names are the flax names (`SegmentEncoder_0`,
    `Dense_0` … `Dense_4`, `LayerNorm_0` … `LayerNorm_3`,
    `MultiHeadDotProductAttention_{0,1}`, `energy_proj`, `snr_proj`,
    `dt_proj`, the heads, `res_w`, `cal_gain`, `cal_bias`), so a flax tree
    maps one to one (train/train_priority.py). flax names Dense layers by
    construction order and builds the MLP's outer (down) projection
    first: layer i's MLP is Dense_{2i+2}(up) then Dense_{2i+1}(down).

The forward runs inside `fp32_exact()`: on a card cuDNN would otherwise
take the float32 convs in TF32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from posteriflow_torch.models.encoder import MultiHeadDotProductAttention
from posteriflow_torch.utils.precision import fp32_exact

SEG_LEN = 2048          # 0.5 s strain segment around each candidate merger
_CONVS = ((3, 16, 32), (16, 32, 16), (32, 64, 8))   # (in, out, kernel)
_STRIDE = 4


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def physics_features(params: torch.Tensor) -> torch.Tensor:
    """[..., P >= 11] physical params -> [..., 8] scale-stable features."""
    m1 = torch.clamp_min(params[..., 0], 1.0)
    m2 = torch.clamp_min(params[..., 1], 1.0)
    d = torch.clamp_min(params[..., 2], 1.0)
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    q = m2 / m1
    loud = mc ** (5.0 / 6.0) / d
    # SNR proxy: 25·(Mc^(5/6)/15.9)·(400/d)
    snr_proxy = 25.0 * (mc ** (5.0 / 6.0) / 15.9) * (400.0 / d)
    return torch.stack([torch.log(mc), q, torch.log(d),
                        torch.log1p(loud * 1e3), torch.log1p(snr_proxy),
                        params[..., 5], params[..., 8],
                        params[..., 9] + params[..., 10]], dim=-1)


def energy_features(seg: torch.Tensor) -> torch.Tensor:
    """[..., 3, L] whitened strain segments -> [..., 12] excess-power
    statistics: per detector and network-summed noise z-scores of the
    segment's energy in merger-centred windows of L, L/4 and L/16."""
    length = seg.shape[-1]
    feats = []
    for w in (length, length // 4, length // 16):
        lo = (length - w) // 2
        e = torch.sum(seg[..., lo:lo + w] ** 2, dim=-1)         # [..., 3]
        z = (e - w) / math.sqrt(2.0 * w)
        feats.append(torch.asinh(z))
        feats.append(torch.asinh(torch.sum(z, dim=-1, keepdim=True)
                                 / math.sqrt(3.0)))
    return torch.cat(feats, dim=-1)


def pair_time_features(params: torch.Tensor, mask: torch.Tensor,
                       snr_est: torch.Tensor,
                       window_s: float = 0.25) -> torch.Tensor:
    """[B, n, P] params + [B, n] mask + [B, n] snr_est -> [B, n, 3]
    time-crowding features: asinh(min |Δt| / window) to the nearest other
    live candidate (|Δt| clipped to 10 s), the number of other live
    candidates within ±window, and asinh(Σ_j≠i snr_j·max(0, 1 − |Δt|/window)
    / 8)."""
    t = params[..., 8]
    dt = torch.abs(t[:, :, None] - t[:, None, :])
    eye = torch.eye(t.shape[1], dtype=mask.dtype, device=mask.device)
    other = (mask[:, :, None] * mask[:, None, :]) * (1.0 - eye[None])
    dt_live = torch.where(other > 0, dt, torch.full_like(dt, math.inf))
    min_dt = torch.clamp(torch.amin(dt_live, dim=-1), 0.0, 10.0)
    n_close = torch.sum(dt_live < window_s, dim=-1)
    contam = torch.sum(other * torch.clamp_min(1.0 - dt / window_s, 0.0)
                       * snr_est[:, None, :], dim=-1)
    return torch.stack([torch.asinh(min_dt / window_s),
                        n_close.to(torch.float32),
                        torch.asinh(contam / 8.0)], dim=-1)


class SegmentEncoder(nn.Module):
    """[.., 3, SEG_LEN] whitened strain segment -> [.., width] embedding:
    three GELU convs (stride 4, VALID), mean and max over time, a GELU
    Dense."""

    def __init__(self, width: int = 64):
        super().__init__()
        for i, (c_in, c_out, k) in enumerate(_CONVS):
            setattr(self, f"Conv_{i}", nn.Conv1d(c_in, c_out, k,
                                                 stride=_STRIDE))
        self.Dense_0 = nn.Linear(2 * _CONVS[-1][1], width)

    def forward(self, seg: torch.Tensor) -> torch.Tensor:
        lead = seg.shape[:-2]
        h = seg.reshape((-1,) + tuple(seg.shape[-2:]))
        for i in range(len(_CONVS)):
            h = _gelu(getattr(self, f"Conv_{i}")(h))
        h = torch.cat([h.mean(dim=-1), h.amax(dim=-1)], dim=-1)
        return _gelu(self.Dense_0(h)).reshape(lead + (-1,))


class PriorityNet(nn.Module):
    """segments [B, n, 3, SEG_LEN], params [B, n, P], mask [B, n] (1 = a
    real candidate), snr_est [B, n] (the physics expected network SNR of
    each candidate) -> (priority [B, n], sigma [B, n]), plus the auxiliary
    asinh(SNR/8) regression [B, n] with `with_aux` (zeros without the
    energy branch). Dead slots score -1e9."""

    def __init__(self, d_model: int = 64, n_heads: int = 4,
                 n_layers: int = 2, use_energy: bool = False,
                 use_snr_est: bool = False, use_dt: bool = False,
                 residual_snr: bool = False):
        super().__init__()
        self.d_model, self.n_heads, self.n_layers = d_model, n_heads, n_layers
        self.use_energy, self.use_snr_est = use_energy, use_snr_est
        self.use_dt, self.residual_snr = use_dt, residual_snr
        self.SegmentEncoder_0 = SegmentEncoder(d_model)
        self.Dense_0 = nn.Linear(8, d_model)
        if use_energy:
            self.energy_proj = nn.Linear(12, d_model)
            self.snr_head = nn.Linear(d_model, 1)
        if use_snr_est:
            self.snr_proj = nn.Linear(2, d_model)
        if use_dt:
            self.dt_proj = nn.Linear(3, d_model)
        for i in range(n_layers):
            setattr(self, f"LayerNorm_{2 * i}", nn.LayerNorm(d_model,
                                                             eps=1e-6))
            setattr(self, f"MultiHeadDotProductAttention_{i}",
                    MultiHeadDotProductAttention(d_model, n_heads))
            setattr(self, f"LayerNorm_{2 * i + 1}", nn.LayerNorm(d_model,
                                                                 eps=1e-6))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(2 * d_model,
                                                          d_model))
            setattr(self, f"Dense_{2 * i + 2}", nn.Linear(d_model,
                                                          2 * d_model))
        self.priority_head = nn.Linear(d_model, 1)
        self.uncertainty_head = nn.Linear(d_model, 1)
        if residual_snr:
            self.res_w = nn.Parameter(torch.ones(()))
        self.cal_gain = nn.Parameter(torch.ones(()))
        self.cal_bias = nn.Parameter(torch.zeros(()))

    def forward(self, segments: torch.Tensor, params: torch.Tensor,
                mask: Optional[torch.Tensor] = None, with_aux: bool = False,
                snr_est: Optional[torch.Tensor] = None):
        with fp32_exact():
            return self._forward(segments, params, mask, with_aux, snr_est)

    def _forward(self, segments, params, mask, with_aux, snr_est):
        tok = self.SegmentEncoder_0(segments) + _gelu(
            self.Dense_0(physics_features(params)))
        if self.use_energy:
            tok = tok + _gelu(self.energy_proj(energy_features(segments)))
        snr_norm = None
        if self.use_snr_est and snr_est is not None:
            live = (snr_est if mask is None
                    else torch.where(mask > 0, snr_est,
                                     torch.zeros_like(snr_est)))
            nmax = torch.amax(live, dim=-1, keepdim=True)
            snr_norm = snr_est / torch.clamp_min(nmax, 1e-6)
            sf = torch.stack([torch.asinh(snr_est / 8.0), snr_norm], dim=-1)
            tok = tok + _gelu(self.snr_proj(sf))
        if self.use_dt and snr_est is not None and mask is not None:
            tok = tok + _gelu(self.dt_proj(
                pair_time_features(params, mask, snr_est)))

        attn_mask = None
        if mask is not None:
            live = mask > 0
            attn_mask = live[:, None, None, :] & live[:, None, :, None]
        for i in range(self.n_layers):
            h = getattr(self, f"LayerNorm_{2 * i}")(tok)
            tok = tok + getattr(self, f"MultiHeadDotProductAttention_{i}")(
                h, h, mask=attn_mask)
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(tok)
            tok = tok + getattr(self, f"Dense_{2 * i + 1}")(_gelu(
                getattr(self, f"Dense_{2 * i + 2}")(h)))

        score = self.priority_head(tok)[..., 0]
        if self.residual_snr and snr_norm is not None:
            # oracle-residual head: the score starts at the normalized
            # physics SNR and the head learns the correction
            score = score + self.res_w * snr_norm
        sigma = F.softplus(self.uncertainty_head(tok)[..., 0]) + 1e-3
        score = self.cal_gain * score + self.cal_bias
        if mask is not None:
            score = torch.where(mask > 0, score,
                                torch.full_like(score, -1e9))
        if with_aux:
            aux = (self.snr_head(tok)[..., 0] if self.use_energy
                   else torch.zeros_like(score))
            return score, sigma, aux
        return score, sigma


def ranking_loss(scores: torch.Tensor, targets: torch.Tensor,
                 sigma: torch.Tensor, mask: torch.Tensor,
                 margin_scale: float = 1.0, margin_floor: float = 0.02,
                 aux: Optional[torch.Tensor] = None,
                 snr: Optional[torch.Tensor] = None,
                 close_boost: float = 0.0) -> torch.Tensor:
    """Pairwise adaptive-margin ranking (each pair's margin
    margin_scale·|Δtarget| + floor, near-tie pairs weighted by
    1 + close_boost·e^{-|Δtarget|/0.1}) + ½ MSE + 0.3 × a heteroscedastic
    NLL of sigma against the detached squared error, + 0.2 × the
    auxiliary asinh(SNR/8) regression when `aux` and `snr` are given."""
    pair_mask = mask[:, :, None] * mask[:, None, :]
    dt = targets[:, :, None] - targets[:, None, :]
    ds = scores[:, :, None] - scores[:, None, :]
    want_higher = (dt > 0).to(torch.float32) * pair_mask
    margin = margin_scale * torch.abs(dt) + margin_floor
    pair_w = want_higher * (1.0 + close_boost
                            * torch.exp(-torch.abs(dt) / 0.1))
    rank_term = (torch.sum(pair_w * torch.clamp_min(margin - ds, 0.0))
                 / torch.clamp_min(torch.sum(pair_w), 1.0))
    n_live = torch.clamp_min(torch.sum(mask), 1.0)
    mse = torch.sum(mask * (scores - targets) ** 2) / n_live
    err2 = ((scores - targets) ** 2).detach()
    unc = torch.sum(mask * (0.5 * err2 / sigma ** 2
                            + torch.log(sigma))) / n_live
    total = rank_term + 0.5 * mse + 0.3 * unc
    if aux is not None and snr is not None:
        aux_t = torch.asinh(snr / 8.0)
        total = total + 0.2 * (torch.sum(mask * (aux - aux_t) ** 2)
                               / n_live)
    return total


def rank_uncertainty(scores: torch.Tensor, sigma: torch.Tensor,
                     mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     n_mc: int = 256,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-candidate expected rank displacement [B, n] under the head's
    score uncertainty: E|rank(score + sigma·eps) − rank(score)| over n_mc
    normal draws eps [n_mc, B, n] (given, or drawn from `generator`); the
    rank of a candidate is the number of live candidates scoring above
    it."""
    if eps is None:
        eps = torch.randn((n_mc,) + tuple(scores.shape), generator=generator,
                          device=scores.device)
    pert = scores[None] + sigma[None] * eps
    live = mask > 0
    neg = torch.where(live, torch.zeros_like(scores),
                      torch.full_like(scores, -1e9))

    def ranks(s):
        s = s + neg
        return torch.sum((s[..., None, :] > s[..., :, None])
                         & live[..., None, :], dim=-1)

    disp = torch.abs(ranks(pert) - ranks(scores)[None]).to(torch.float32)
    return torch.mean(disp, dim=0) * mask


def rank_by_score(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Descending-priority candidate order; masked slots last (a stable
    sort, as jnp.argsort)."""
    s = torch.where(mask > 0, scores, torch.full_like(scores, -math.inf))
    return torch.argsort(-s, dim=-1, stable=True)


def loudness_fallback(params: torch.Tensor) -> torch.Tensor:
    """The SNR-proxy ranking score log1p(snr_proxy) when no trained
    PriorityNet is available."""
    return physics_features(params)[..., 4]
