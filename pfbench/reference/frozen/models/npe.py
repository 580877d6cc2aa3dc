"""LeanNPE: encoder + rank embedding + coupling-NSF flow (torch).

Port of posteriflow_tpu/models/npe.py:30-137. The flow context is
[encoder(strain) ∥ rank_embedding(rank)], so one encoder pass serves the
posterior query of every overlapping signal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from pfbench.reference.frozen import PARAM_NAMES
from pfbench.reference.frozen.models.encoder import CoherentEncoder, LeanStrainEncoder
from pfbench.reference.frozen.models.flow import CouplingNSF
from pfbench.reference.frozen.scaler import ParamScaler


@dataclasses.dataclass(frozen=True)
class NPEConfig:
    """Static model configuration (the `npe` part of a release's
    meta.json)."""
    param_names: tuple = PARAM_NAMES
    context_dim: int = 256
    rank_dim: int = 32
    max_signals: int = 5
    flow_layers: int = 10
    flow_hidden: int = 256
    flow_bins: int = 16
    tail_bound: float = 5.0
    encoder_type: str = "coherent"       # "conv" | "coherent"
    psd_cond: bool = False
    psd_bands: int = 16
    premerger: bool = False
    d_model: int = 192
    enc_layers: int = 3
    enc_heads: int = 6
    flow_dtype: str = "bfloat16"     # conditioner matmul dtype (RQS is f32)
    encoder_dtype: str = "float32"   # encoder matmul/conv dtype

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    @property
    def uses_asd_bands(self) -> bool:
        # the coherent encoder always takes asd_bands
        return self.psd_cond or self.encoder_type == "coherent"


class LeanNPE(nn.Module):
    def __init__(self, cfg: NPEConfig = NPEConfig()):
        super().__init__()
        self.cfg = c = cfg
        enc_kw = dict(context_dim=c.context_dim, d_model=c.d_model,
                      n_layers=c.enc_layers, n_heads=c.enc_heads,
                      psd_bands=c.psd_bands if c.uses_asd_bands else 0,
                      compute_dtype=c.encoder_dtype)
        enc_cls = (CoherentEncoder if c.encoder_type == "coherent"
                   else LeanStrainEncoder)
        self.encoder = enc_cls(**enc_kw)
        self.rank_embed = nn.Embedding(c.max_signals, c.rank_dim)
        self.flow = CouplingNSF(
            features=c.n_params, context_features=c.context_dim + c.rank_dim,
            num_layers=c.flow_layers, hidden=c.flow_hidden,
            num_bins=c.flow_bins, tail_bound=c.tail_bound,
            compute_dtype=c.flow_dtype)
        self.scaler = ParamScaler(c.param_names, premerger=c.premerger)

    def encode(self, strain: torch.Tensor,
               asd_bands: Optional[torch.Tensor] = None) -> torch.Tensor:
        """strain [B, 3, T] whitened -> context [B, context_dim]."""
        if self.cfg.uses_asd_bands:
            return self.encoder(strain, asd_bands)
        return self.encoder(strain)

    def full_context(self, context: torch.Tensor,
                     rank: torch.Tensor) -> torch.Tensor:
        return torch.cat([context, self.rank_embed(rank)], dim=-1)

    def nll_from_context(self, context: torch.Tensor,
                         theta_phys: torch.Tensor,
                         rank: torch.Tensor) -> torch.Tensor:
        """context [B, C]; theta_phys [B, P] physical; rank [B] -> [B]."""
        ctx = self.full_context(context, rank)
        y = self.scaler.normalize(theta_phys)
        return -self.flow.log_prob(y, ctx)

    def sample_from_context(self, context: torch.Tensor, rank: torch.Tensor,
                            n_samples: int,
                            generator: Optional[torch.Generator] = None,
                            z: Optional[torch.Tensor] = None):
        """context [B, C], rank [B] -> (physical samples [B, n, P],
        wrapped normalized samples [B, n, P], log q_norm [B, n]).

        Base draws z [B, n, P] come from `generator`, or are given, so that
        a test can feed both packages the same draws. The context keeps a
        broadcast dim, so the conditioner projects it once per event."""
        ctx = self.full_context(context, rank)               # [B, C+R]
        if z is None:
            z = torch.randn((ctx.shape[0], n_samples, self.cfg.n_params),
                            generator=generator, device=ctx.device)
        y, log_q = self.flow.sample_with_log_prob(z, ctx[:, None, :])
        y = self.scaler.wrap(y)
        return self.scaler.denormalize(y), y, log_q
