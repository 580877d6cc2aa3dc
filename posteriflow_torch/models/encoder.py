"""Strain encoders (torch): whitened [B, 3, 16384] -> context vector.

Port of posteriflow_tpu/models/encoder.py:38-283. Layouts and numerics
follow the flax modules so that released weights load one to one:

  - the conv stem is flax's NWC conv with VALID padding (weights carried
    from [k, in, out] to torch's [out, in, k]); 16384 samples -> 61 tokens;
  - LayerNorm eps is flax's 1e-6;
  - attention is flax MultiHeadDotProductAttention written out as matmul +
    softmax: the query is divided by sqrt(head_dim) in the compute dtype,
    the softmax is taken in the compute dtype;
  - matmuls and convs run in `compute_dtype` (flax `dtype=`), the residual
    stream, LayerNorms and all geometry/energy features stay float32;
    float32 products run with TF32 off (utils/precision.fp32_exact), as
    JAX computes them;
  - GELU is the tanh approximation (flax nn.gelu).

Module names are the flax names (stem.Conv_0, fusion_0.LayerNorm_0,
fusion_0.MultiHeadDotProductAttention_0.query, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from posteriflow_torch.models.flow import DTYPES, dense, gelu, in_dtype
from posteriflow_torch.physics.constants import (F_LOWER, F_UPPER, N_SAMPLES,
                                                 SAMPLE_RATE)
from posteriflow_torch.utils.precision import fp32_exact

STEM_SCHEDULE = ((32, 64, 8), (64, 16, 4), (128, 8, 4))   # (out, k, stride)
STEM_LAST = (4, 2)                                         # d_model out


def sinusoidal_positions(n: int, d_model: int) -> np.ndarray:
    """[n, d_model] fixed sin/cos position encoding (float32 numpy)."""
    pos = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe = np.zeros((n, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class ConvStem(nn.Module):
    """Norm-free strided conv1d stack: [B, T] -> [B, L, d_model]
    (k64/s8 → k16/s4 → k8/s4 → k4/s2, VALID padding)."""

    def __init__(self, d_model: int = 192, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        sched = STEM_SCHEDULE + ((d_model,) + STEM_LAST,)
        in_ch = 1
        for i, (feat, k, s) in enumerate(sched):
            self.add_module(f"Conv_{i}", nn.Conv1d(in_ch, feat, k, stride=s))
            in_ch = feat
        self.n_convs = len(sched)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = x[:, None, :]
        with fp32_exact():                 # no TF32 for a float32 stem
            for i in range(self.n_convs):
                conv = getattr(self, f"Conv_{i}")
                h = torch.nn.functional.conv1d(h.to(dt), conv.weight.to(dt),
                                               stride=conv.stride)
                h = gelu(h + conv.bias.to(dt)[:, None])
        return h.transpose(1, 2)


class MultiHeadDotProductAttention(nn.Module):
    """flax MultiHeadDotProductAttention (no dropout): q/k/v/out
    projections are flax DenseGeneral kernels carried into nn.Linear. A
    boolean `mask` [B, 1, Lq, Lk] sets the logits it excludes to the
    dtype's most negative finite value, as flax does (not -inf): a query
    whose keys are all masked then attends uniformly and stays finite."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        b, lq, dm = inputs_q.shape
        lk = inputs_kv.shape[1]
        hd = dm // self.n_heads
        q = dense(self.query, inputs_q, dt).view(b, lq, self.n_heads, hd)
        k = dense(self.key, inputs_kv, dt).view(b, lk, self.n_heads, hd)
        v = dense(self.value, inputs_kv, dt).view(b, lk, self.n_heads, hd)
        q = q / in_dtype(math.sqrt(hd), dt)  # query / sqrt(depth) in dt
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = torch.where(mask, w, torch.finfo(w.dtype).min)
        # jax.nn.softmax in the compute dtype: exp and the division each
        # round to that dtype (torch.softmax would round once)
        w = torch.exp(w - torch.amax(w, dim=-1, keepdim=True))
        w = w / torch.sum(w, dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return dense(self.out, o.reshape(b, lq, self.n_heads * hd), dt)


class TransformerBlock(nn.Module):
    """Pre-norm transformer encoder layer (ff 4×, GELU); float32 residual
    stream, matmuls in `dtype`."""

    def __init__(self, d_model: int = 192, n_heads: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=1e-6)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads, dtype)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=1e-6)
        self.Dense_0 = nn.Linear(d_model, 4 * d_model)
        self.Dense_1 = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(h, h)
        h = self.LayerNorm_1(x)
        h = gelu(dense(self.Dense_0, h, self.dtype))
        return x + dense(self.Dense_1, h, self.dtype)


class AttentionPool(nn.Module):
    """n_queries learned queries cross-attend into the token sequence."""

    def __init__(self, d_model: int = 192, n_heads: int = 6,
                 n_queries: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.queries = nn.Parameter(torch.randn(n_queries, d_model)
                                    / math.sqrt(d_model))
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b = tokens.shape[0]
        q = self.queries.expand(b, -1, -1)
        pooled = self.MultiHeadDotProductAttention_0(q, tokens)
        return pooled.reshape(b, -1).float()                 # [B, nq*d]


class LeanStrainEncoder(nn.Module):
    """Whitened 3-detector strain -> flat context [B, context_dim]: a
    log-energy branch on raw strain, a conv stem on asinh-compressed strain,
    a fusion transformer, attention pooling and an optional PSD branch."""

    def __init__(self, n_detectors: int = 3, d_model: int = 192,
                 n_layers: int = 3, n_heads: int = 6,
                 n_pool_queries: int = 8, n_energy_windows: int = 16,
                 context_dim: int = 256, psd_bands: int = 0,
                 compute_dtype: str = "float32"):
        super().__init__()
        dt = DTYPES[compute_dtype]
        self.n_detectors = n_detectors
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_energy_windows = n_energy_windows
        self.psd_bands = psd_bands
        self.energy_fc1 = nn.Linear(n_detectors * n_energy_windows, 64)
        self.energy_fc2 = nn.Linear(64, 64)
        self.stem = ConvStem(d_model, dt)
        self.detector_embed = nn.Parameter(
            0.02 * torch.randn(n_detectors, d_model))
        for i in range(n_layers):
            self.add_module(f"fusion_{i}",
                            TransformerBlock(d_model, n_heads, dt))
        self.pool = AttentionPool(d_model, n_heads, n_pool_queries, dt)
        n_feat = n_pool_queries * d_model + 64
        if psd_bands > 0:
            self.noise_fc1 = nn.Linear(n_detectors * psd_bands, 64)
            self.noise_fc2 = nn.Linear(64, 32)
            n_feat += 32
        self.out_fc1 = nn.Linear(n_feat, 512)
        self.out_fc2 = nn.Linear(512, context_dim)

    def geometry_tokens(self, strain: torch.Tensor) -> Optional[torch.Tensor]:
        """Subclass hook: [B, n, d_model] tokens put before the strain
        tokens."""
        return None

    def forward(self, strain: torch.Tensor,
                asd_bands: Optional[torch.Tensor] = None) -> torch.Tensor:
        with fp32_exact():
            return self._forward(strain, asd_bands)

    def _forward(self, strain: torch.Tensor,
                 asd_bands: Optional[torch.Tensor]) -> torch.Tensor:
        b, d, t = strain.shape
        strain = torch.clamp(torch.nan_to_num(strain, nan=0.0, posinf=100.0,
                                              neginf=-100.0), -100.0, 100.0)

        # energy branch from raw strain
        w = self.n_energy_windows
        win = strain[..., : (t // w) * w].reshape(b, d, w, -1)
        e = torch.log(torch.mean(win ** 2, dim=-1) + 1e-8).reshape(b, -1)
        energy_feat = gelu(self.energy_fc2(gelu(self.energy_fc1(e))))

        extra = self.geometry_tokens(strain)

        # token branch on asinh-compressed strain
        tokens = self.stem(torch.asinh(strain).reshape(b * d, t))
        length = tokens.shape[1]
        pe = torch.as_tensor(sinusoidal_positions(length, self.d_model),
                             device=strain.device)
        tokens = tokens + pe[None]                            # float32
        tokens = tokens.reshape(b, d, length, self.d_model)
        tokens = tokens + self.detector_embed[None, :, None, :]
        tokens = tokens.reshape(b, d * length, self.d_model)
        if extra is not None:
            tokens = torch.cat([extra, tokens], dim=1)
        tokens = tokens.float()
        for i in range(self.n_layers):
            tokens = getattr(self, f"fusion_{i}")(tokens)

        feats = [self.pool(tokens), energy_feat]
        if self.psd_bands > 0:
            if asd_bands is None:        # zeros = design sensitivity
                asd_bands = torch.zeros(b, self.n_detectors, self.psd_bands,
                                        device=strain.device)
            a = gelu(self.noise_fc1(asd_bands.reshape(b, -1)))
            feats.append(gelu(self.noise_fc2(a)))
        h = gelu(self.out_fc1(torch.cat(feats, dim=-1)))
        return self.out_fc2(h)


class CoherentEncoder(LeanStrainEncoder):
    """LeanStrainEncoder with geometry tokens (encoder.py:210-283): log band
    powers of the unitary rfft over [20, 1024) Hz, per-pair power-weighted
    complex coherence, the GCC delay (argmax over the ±30 ms lag window,
    computed as a cos/sin lag matmul) with its peak sharpness, and per-pair
    log amplitude ratios, MLP'd into n_geom_tokens tokens."""

    def __init__(self, *args, geometry_bands: int = 16, geom_hidden: int = 128,
                 n_geom_tokens: int = 4, tau_max_ms: float = 30.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.geometry_bands = geometry_bands
        self.n_geom_tokens = n_geom_tokens
        self.maxlag = int(tau_max_ms * 1e-3 * SAMPLE_RATE)

        freqs = np.fft.rfftfreq(N_SAMPLES, 1.0 / SAMPLE_RATE)
        band = (freqs >= F_LOWER) & (freqs < F_UPPER)
        self.lo = int(np.argmax(band))
        self.nf = int(band.sum())
        fb = freqs[band]
        edges = np.geomspace(F_LOWER, F_UPPER, geometry_bands + 1)
        bsum = np.zeros((geometry_bands, self.nf), dtype=np.float32)
        for k in range(geometry_bands):
            bsum[k] = (fb >= edges[k]) & (fb < edges[k + 1])
        k_idx = np.arange(self.lo, self.lo + self.nf, dtype=np.float64)
        lags = np.arange(-self.maxlag, self.maxlag + 1, dtype=np.float64)
        phase = 2.0 * np.pi * np.outer(k_idx, lags) / N_SAMPLES
        consts = {
            "bsum": bsum,
            "bcount": np.maximum(bsum.sum(1), 1.0).astype(np.float32),
            "cos_l": np.cos(phase).astype(np.float32),
            "sin_l": np.sin(phase).astype(np.float32),
            "lags_norm": (np.arange(-self.maxlag, self.maxlag + 1,
                                    dtype=np.float32) / self.maxlag),
        }
        for name, arr in consts.items():
            self.register_buffer(name, torch.from_numpy(arr),
                                 persistent=False)

        n_pairs = self.n_detectors * (self.n_detectors - 1) // 2
        n_geom = (self.n_detectors * geometry_bands
                  + n_pairs * (3 * geometry_bands + 3))
        self.geom_fc1 = nn.Linear(n_geom, geom_hidden)
        self.geom_fc2 = nn.Linear(geom_hidden, geom_hidden)
        self.geom_to_tokens = nn.Linear(geom_hidden,
                                        n_geom_tokens * self.d_model)

    def geometry_tokens(self, strain: torch.Tensor) -> torch.Tensor:
        b = strain.shape[0]
        fd = torch.fft.rfft(strain, dim=-1) / math.sqrt(N_SAMPLES)  # unitary
        dslice = fd[..., self.lo:self.lo + self.nf]                 # [B,D,Nf]
        dr, di = dslice.real, dslice.imag
        power = dr ** 2 + di ** 2
        amp = torch.sqrt(power + 1e-12)
        bsum_t = self.bsum.T
        e_band = (power @ bsum_t) / self.bcount
        feats = [torch.log(e_band + 1e-8).reshape(b, -1)]

        for i in range(self.n_detectors):
            for j in range(i + 1, self.n_detectors):
                xr = dr[:, i] * dr[:, j] + di[:, i] * di[:, j]  # Re(d_i d_j*)
                xi = di[:, i] * dr[:, j] - dr[:, i] * di[:, j]  # Im(d_i d_j*)
                num_r = xr @ bsum_t
                num_i = xi @ bsum_t
                den = (amp[:, i] * amp[:, j]) @ bsum_t + 1e-8
                gr, gi = num_r / den, num_i / den
                gmag = torch.sqrt(gr ** 2 + gi ** 2) + 1e-8
                feats += [gmag, gr / gmag, gi / gmag]

                # GCC delay: the lag-limited cross-correlation as a matmul
                a = torch.abs(xr @ self.cos_l - xi @ self.sin_l)  # [B, lags]
                tau = self.lags_norm[torch.argmax(a, dim=-1)][:, None]
                peak = (torch.amax(a, dim=-1)
                        / (torch.mean(a, dim=-1) + 1e-8))[:, None]
                feats += [tau, peak]

                ei = torch.sum(power[:, i], dim=-1)
                ej = torch.sum(power[:, j], dim=-1)
                feats.append((torch.log(ei + 1e-8)
                              - torch.log(ej + 1e-8))[:, None])

        g = gelu(self.geom_fc1(torch.cat(feats, dim=-1)))
        g = gelu(self.geom_fc2(g))
        g = self.geom_to_tokens(g)
        return g.reshape(b, self.n_geom_tokens, self.d_model)
