"""Calibration-gated checkpoint selection (torch).

Port of posteriflow_tpu/train/gates.py:29-153. Device side: railing
fraction, base-space concentration E‖z‖²/D, coverage (overall and at high
SNR) and SBC ranks. Host side: SBC KS-uniformity p-values (scipy), the gate
decision, and gated best-epoch selection.

The base draws come from `generator`, or are given (`z` [n, n_post, P]) so
that a test can hand over JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from posteriflow_torch.models.npe import LeanNPE
from posteriflow_torch.physics.simulator import EventBatch


@dataclasses.dataclass(frozen=True)
class CalibrationGate:
    """Pass thresholds (README spec + validate_checkpoint.py:173-199)."""
    max_spurious_railing: float = 0.10
    base_conc_range: tuple = (0.5, 2.0)
    min_cov90: float = 0.80
    min_sbc_pass_frac: float = 9.0 / 11.0
    sbc_ks_p: float = 1e-3

    def passes(self, m: dict) -> bool:
        return (m["spurious_railing"] <= self.max_spurious_railing
                and self.base_conc_range[0] <= m["base_conc"]
                <= self.base_conc_range[1]
                and m["cov90_mean"] >= self.min_cov90
                and m.get("sbc_pass_frac", 1.0) >= self.min_sbc_pass_frac)


def make_calibration_metrics(cfg, n_events: int = 256, n_post: int = 128,
                             high_snr: float = 15.0):
    """fn(model, batch, generator=None, z=None) -> device metrics dict
    (tensors) with the SBC ranks and the live mask."""

    def metrics(model: LeanNPE, batch: EventBatch,
                generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None) -> dict:
        n = min(n_events, batch.strain.shape[0])
        dev = batch.strain.device
        with torch.no_grad():
            strain = batch.strain[:n]
            theta0 = batch.params[:n, 0, :]
            asd = batch.asd_bands[:n] if cfg.npe.uses_asd_bands else None
            rank0 = torch.zeros(n, dtype=torch.long, device=dev)
            live = (batch.n_sig[:n] > 0).float()
            n_live = torch.clamp(torch.sum(live), min=1.0)

            ctx = model.encode(strain, asd)
            # base-space concentration: z = forward(normalize(truth));
            # E‖z‖²/D ≈ 1 for a calibrated flow
            full_ctx = model.full_context(ctx, rank0)
            z_true, _ = model.flow.forward(model.scaler.normalize(theta0),
                                           full_ctx)
            conc = torch.sum(z_true ** 2, dim=-1) / cfg.npe.n_params
            base_conc = torch.sum(conc * live) / n_live

            theta_s, y_raw, _ = model.sample_from_context(
                ctx, rank0, n_post, generator=generator,
                z=None if z is None else z.to(dev))
            railed = model.scaler.railing_mask(y_raw).float()  # [n, n_post]
            spurious_railing = (torch.sum(railed * live[:, None])
                                / (n_live * n_post))

            lo90 = torch.quantile(theta_s, 0.05, dim=1)
            hi90 = torch.quantile(theta_s, 0.95, dim=1)
            in90 = ((theta0 >= lo90) & (theta0 <= hi90)).float()
            cov90 = torch.sum(in90 * live[:, None], dim=0) / n_live
            hs = live * (batch.net_snr[:n] >= high_snr).float()
            n_hs = torch.clamp(torch.sum(hs), min=1.0)
            cov90_hs = torch.sum(in90 * hs[:, None], dim=0) / n_hs

            # SBC ranks: the truth's position among the draws, per param
            ranks = torch.sum((theta_s < theta0[:, None, :]).int(), dim=1)
        return {
            "spurious_railing": spurious_railing,
            "base_conc": base_conc,
            "cov90_all": cov90,
            "cov90_mean": torch.mean(cov90),
            "cov90_highsnr_mean": torch.mean(cov90_hs),
            "sbc_ranks": ranks,
            "live_mask": live,
        }

    return metrics


def sbc_pass_frac(ranks: np.ndarray, live: np.ndarray, n_post: int,
                  p_thresh: float = 1e-3) -> tuple[float, np.ndarray]:
    """Host: KS-uniformity p per parameter over live events; returns
    (fraction of params with p > threshold, p-values [P])."""
    from scipy.stats import kstest
    ranks = np.asarray(ranks)[np.asarray(live) > 0]
    if ranks.shape[0] < 8:
        return 1.0, np.ones(ranks.shape[-1])
    u = (ranks + 0.5) / (n_post + 1.0)
    ps = np.array([kstest(u[:, j], "uniform").pvalue
                   for j in range(u.shape[1])])
    return float(np.mean(ps > p_thresh)), ps


def evaluate_gate(cfg, model: LeanNPE, batch: EventBatch,
                  generator: Optional[torch.Generator] = None,
                  gate: CalibrationGate = CalibrationGate(),
                  n_post: int = 128, metrics_fn=None,
                  z: Optional[torch.Tensor] = None) -> dict:
    """Device metrics + SBC KS + verdict, as floats and lists."""
    fn = metrics_fn or make_calibration_metrics(cfg, n_post=n_post)
    m = fn(model, batch, generator=generator, z=z)
    out = {k: float(v) for k, v in m.items()
           if k not in ("sbc_ranks", "live_mask", "cov90_all")}
    out["cov90_all"] = m["cov90_all"].cpu().numpy().tolist()
    frac, ps = sbc_pass_frac(m["sbc_ranks"].cpu().numpy(),
                             m["live_mask"].cpu().numpy(), n_post,
                             gate.sbc_ks_p)
    out["sbc_pass_frac"] = frac
    out["sbc_ks_p"] = ps.tolist()
    out["gate_passed"] = gate.passes(out)
    return out


def select_best(history: list[dict], select_key: str = "select_nll") -> int:
    """Gated best-epoch selection: lowest selection NLL among gate-passing
    epochs; if none passes yet, lowest NLL overall."""
    passing = [h for h in history if h.get("gate_passed")]
    pool = passing if passing else history
    best = min(pool, key=lambda h: h[select_key])
    return best["epoch"]
