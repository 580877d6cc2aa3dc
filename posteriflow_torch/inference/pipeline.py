"""infer(): raw strain -> PosteriorResult in one call; infer_overlapping()
for rank-conditioned multi-signal events.

Port of posteriflow_tpu/inference/pipeline.py:37-203. The path: data prep
(raw strain through prepare_real, or an injection through the simulator)
-> encode once -> base draws -> coupling-flow inverse (the RQS kernel in
every layer) -> wrap -> denormalize -> physical-units log q -> m1 >= m2 ->
OOD score + confidence verdict -> refinement gate.

Entry points run on the card ("cuda") unless the caller names another
device; randomness comes from an explicit torch.Generator.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from posteriflow_torch.inference.gating import load_bias_map, refinement_gate
from posteriflow_torch.inference.ood import (ContextStats, confidence_verdict,
                                             score_context)
from posteriflow_torch.inference.preprocessing import (PreparedData,
                                                       prepare_real,
                                                       prepare_simulated)
from posteriflow_torch.inference.result import PosteriorResult
from posteriflow_torch.models.npe import LeanNPE, NPEConfig
from posteriflow_torch.train.checkpoints import (load_checkpoint_model,
                                                 load_release)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class InferenceEngine:
    """A loaded release on one device: the model in eval mode, its scaler,
    the OOD statistics and the amortization-bias map."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], cfg: NPEConfig,
                 ood_stats: Optional[ContextStats] = None,
                 bias_map: Optional[dict] = None, device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg
        self.model = LeanNPE(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.scaler = self.model.scaler
        self.ood_stats = ood_stats
        self.bias_map = bias_map

    @classmethod
    def from_checkpoint(cls, ckpt_dir, name: str = "best", device="cuda"):
        """-> engine on `device` from a release directory (params.msgpack +
        meta.json), or from the training checkpoint `name` under a
        CheckpointManager root (e.g. <outdir>/ckpt). Either directory may
        hold ood_stats.npz and twin_grid.json. FileNotFoundError if it
        holds neither."""
        ckpt_dir = Path(ckpt_dir)
        if (ckpt_dir / "params.msgpack").exists():
            state_dict, cfg, _meta = load_release(ckpt_dir)
        else:
            state_dict, train_cfg, _meta = load_checkpoint_model(ckpt_dir,
                                                                 name)
            cfg = train_cfg.npe
        ood_path = ckpt_dir / "ood_stats.npz"
        stats = ContextStats.load(ood_path) if ood_path.exists() else None
        bias_map = (load_bias_map(ckpt_dir / "twin_grid.json")
                    or load_bias_map())
        return cls(state_dict, cfg, ood_stats=stats, bias_map=bias_map,
                   device=device)

    @torch.no_grad()
    def encode(self, strain, asd_bands) -> torch.Tensor:
        """strain [B, 3, T], asd_bands [B, 3, K] (numpy or tensors) ->
        context [B, C] on the engine's device."""
        s = torch.as_tensor(strain, dtype=torch.float32, device=self.device)
        asd = (torch.as_tensor(asd_bands, dtype=torch.float32,
                               device=self.device)
               if self.cfg.uses_asd_bands else None)
        return self.model.encode(s, asd)

    @torch.no_grad()
    def sample_posterior(self, context: torch.Tensor, rank: int,
                         n_samples: int,
                         generator: Optional[torch.Generator] = None,
                         z: Optional[torch.Tensor] = None):
        """context [B, C] -> (theta [B, n, P] physical with m1 >= m2,
        log q_phys [B, n], railed [B, n])."""
        r = torch.full((context.shape[0],), rank, dtype=torch.long,
                       device=context.device)
        theta, y_raw, log_q_norm = self.model.sample_from_context(
            context, r, n_samples, generator=generator, z=z)
        railed = self.scaler.railing_mask(y_raw)
        # physical-units density: log q_phys(x) = log q_norm(y) +
        # log|d normalize/dx|
        log_q_phys = log_q_norm + self.scaler.log_abs_det_jacobian(theta)
        m1 = torch.maximum(theta[..., 0], theta[..., 1])
        m2 = torch.minimum(theta[..., 0], theta[..., 1])
        theta = torch.cat([m1[..., None], m2[..., None], theta[..., 2:]],
                          dim=-1)
        return theta, log_q_phys, railed


_ENGINE_CACHE: Dict[str, InferenceEngine] = {}


def load_model(release_dir, device="cuda") -> InferenceEngine:
    """Cached InferenceEngine.from_checkpoint, one per (dir, device)."""
    key = f"{Path(release_dir).resolve()}::{torch.device(device)}"
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = InferenceEngine.from_checkpoint(release_dir,
                                                             device=device)
    return _ENGINE_CACHE[key]


def _prepare(engine: InferenceEngine, data=None, strain=None, gps=None,
             inject=None, seed: int = 0, draws=None) -> PreparedData:
    if isinstance(data, PreparedData):
        return data
    if inject is not None:
        return prepare_simulated(inject, seed=seed,
                                 psd_bands=engine.cfg.psd_bands,
                                 param_names=engine.cfg.param_names,
                                 device=engine.device, draws=draws)
    if strain is not None:
        return prepare_real(strain, gps_time=gps or 0.0,
                            psd_bands=engine.cfg.psd_bands)
    raise ValueError("provide PreparedData, raw strain, or an injection")


def infer(engine: InferenceEngine, data=None, strain=None, gps=None,
          inject=None, rank: int = 0, n_samples: int = 5000, seed: int = 0,
          generator: Optional[torch.Generator] = None,
          z: Optional[torch.Tensor] = None, draws=None) -> PosteriorResult:
    """One-call amortized inference -> PosteriorResult.

    strain: {detector: raw long strain} for prepare_real; inject: the
    parameters of an injection for prepare_simulated (dicts or an array),
    simulated on the engine's device with noise from `seed` (or from
    `draws`, a SimDraws of one event); or `data` as PreparedData. The base
    draws are `z` [1, n_samples, P] if given, else come from `generator`,
    else from a generator on the engine's device seeded with seed + 7."""
    timings = {}
    prepared = _prepare(engine, data, strain, gps, inject, seed, draws)
    timings.update(prepared.timings)
    dev = engine.device

    t0 = time.perf_counter()
    ctx = engine.encode(prepared.strain[None], prepared.asd_bands[None])
    _sync(dev)
    timings["encode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if generator is None and z is None:
        generator = torch.Generator(device=dev).manual_seed(seed + 7)
    theta, log_q, railed = engine.sample_posterior(
        ctx, rank, n_samples, generator=generator,
        z=None if z is None else z.to(dev))
    samples = theta[0].cpu().numpy()
    timings["sampling"] = time.perf_counter() - t0

    railed_np = railed[0].cpu().numpy()
    railing_frac = float(railed_np.mean())
    if engine.ood_stats is not None:
        _, pct = score_context(engine.ood_stats,
                               ctx.float().cpu().numpy())
        ood_pct = float(pct[0])
    else:
        ood_pct = 0.0
    verdict = confidence_verdict(ood_pct, railing_frac, prepared.warnings)
    gate = refinement_gate(verdict, ood_pct, railing_frac, samples,
                           bias_map=engine.bias_map)

    diag = {
        "runtime": timings,
        "ood_percentile": ood_pct,
        "quality_warnings": prepared.warnings,
        "n_samples": n_samples,
        "draws_per_sec": n_samples / max(timings["sampling"], 1e-9),
        "device": str(dev),
    }
    return PosteriorResult(samples=samples,
                           log_prob=log_q[0].cpu().numpy(),
                           param_names=tuple(engine.cfg.param_names),
                           rank=rank, railed=railed_np, diagnostics=diag,
                           gate=gate, verdict=verdict,
                           gps_time=prepared.gps_time)


def infer_overlapping(engine: InferenceEngine, data=None, n_signals: int = 2,
                      n_samples: int = 5000, seed: int = 0,
                      **prep_kwargs) -> List[PosteriorResult]:
    """One posterior per rank, reusing the PreparedData."""
    prepared = _prepare(engine, data, seed=seed, **prep_kwargs)
    return [infer(engine, data=prepared, rank=r, n_samples=n_samples,
                  seed=seed) for r in range(n_signals)]
