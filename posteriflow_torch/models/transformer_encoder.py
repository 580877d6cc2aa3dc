"""Auxiliary strain encoders: the lightweight patch transformer and the
gated pretrained-audio (Whisper) encoder.

Port of posteriflow_tpu/models/transformer_encoder.py:

  - LightweightTransformerEncoder: raw whitened strain cut into patches
    (no convolutions), a linear patch embedding, sinusoidal positions and
    a learned per-detector embedding, pre-norm transformer blocks over all
    detectors' patches, then mean and max pooling and a linear head. Its
    module names are flax's (patch_embed, det_embed, block_i, out), so a
    flax parameter tree loads through train/checkpoints.flax_to_state_dict;
  - PretrainedAudioEncoder: a HuggingFace Whisper encoder (torch's
    `transformers.WhisperModel`, imported inside the functions that need
    it) from locally cached weights only; without them, or without the
    package, it raises the JAX package's RuntimeError. `from_config`
    builds a random-initialised Whisper encoder from a WhisperConfig,
    offline.
"""

from __future__ import annotations

import torch
from torch import nn

from posteriflow_torch.models.encoder import (TransformerBlock,
                                              sinusoidal_positions)
from posteriflow_torch.utils.precision import fp32_exact


class LightweightTransformerEncoder(nn.Module):
    """[B, n_det, T] whitened strain -> [B, out_dim], float32."""

    def __init__(self, patch: int = 256, d_model: int = 96,
                 n_layers: int = 4, n_heads: int = 6, out_dim: int = 64,
                 n_det: int = 3):
        super().__init__()
        self.patch, self.d_model, self.n_layers = patch, d_model, n_layers
        self.patch_embed = nn.Linear(patch, d_model)
        self.det_embed = nn.Parameter(0.02 * torch.randn(n_det, d_model))
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(d_model, n_heads))
        self.out = nn.Linear(2 * d_model, out_dim)

    def forward(self, strain: torch.Tensor) -> torch.Tensor:
        b, d, t = strain.shape
        x = torch.clamp(torch.nan_to_num(strain), -100.0, 100.0)
        n_patch = t // self.patch
        x = torch.asinh(x[..., : n_patch * self.patch])
        x = x.reshape(b, d, n_patch, self.patch)
        with fp32_exact():
            tok = self.patch_embed(x)                          # [B,D,L,dm]
            pos = torch.from_numpy(sinusoidal_positions(
                n_patch, self.d_model)).to(tok.device)
            tok = tok + pos[None, None]
            tok = (tok + self.det_embed[None, :, None, :]).reshape(
                b, d * n_patch, self.d_model)
            for i in range(self.n_layers):
                tok = getattr(self, f"block_{i}")(tok)
            pooled = torch.cat([tok.mean(dim=1), tok.amax(dim=1)], dim=-1)
            return self.out(pooled)


_GATED = ("PretrainedAudioEncoder needs locally cached weights for "
          "{name!r} (zero-egress environment). Use "
          "LightweightTransformerEncoder instead.")


class PretrainedAudioEncoder:
    """Gated Whisper-encoder front end: locally cached HuggingFace weights
    only, on `device`."""

    def __init__(self, model_name: str = "openai/whisper-small",
                 out_dim: int = 64, device="cuda"):
        self.out_dim = out_dim
        self.device = torch.device(device)
        try:
            from transformers import WhisperModel
            model = WhisperModel.from_pretrained(model_name,
                                                 local_files_only=True)
        except Exception as e:
            raise RuntimeError(_GATED.format(name=model_name)) from e
        self._encoder = model.encoder.to(self.device).eval()

    @classmethod
    def from_config(cls, config, out_dim: int = 64, device="cuda"):
        """A random-initialised Whisper encoder from a
        transformers.WhisperConfig (no download). It takes strain shaped
        [B, config.num_mel_bins, T] with T = 2 · max_source_positions
        (Whisper's stride-2 stem). Only the encoder is built: encode uses
        nothing else, and torch's decoder embedding rejects a pad token
        id at or past vocab_size, as small test configs have (flax's does
        not check)."""
        from transformers.models.whisper.modeling_whisper import \
            WhisperEncoder
        self = cls.__new__(cls)
        self.out_dim = out_dim
        self.device = torch.device(device)
        self._encoder = WhisperEncoder(config).to(self.device).eval()
        return self

    @torch.no_grad()
    def encode(self, strain) -> torch.Tensor:
        """[B, n_mel, T] -> [B, out_dim]: the encoder's last hidden state
        averaged over time, its first out_dim features."""
        x = torch.as_tensor(strain, dtype=torch.float32, device=self.device)
        feats = self._encoder(input_features=x).last_hidden_state
        return feats.mean(dim=1)[..., : self.out_dim]
