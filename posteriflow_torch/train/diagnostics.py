"""Per-epoch conditional-inference diagnostics (torch).

Port of posteriflow_tpu/train/diagnostics.py:25-87, answering every epoch:
is the flow actually conditioning on the data?

  shuffle_delta_nll — val NLL with contexts shuffled across events minus
                      matched-context NLL (~0 ⇒ marginal fit, should grow)
  dist_corr         — corr(log posterior-median distance, log true distance)
  cov50 / cov90     — empirical central credible-interval coverage for
                      every parameter from n_post posterior draws per event

The permutation and the base draws come from `generator`, or are given
(`perm` [n], `z` [n, n_post, P]) so that a test can hand over JAX's. The
median is torch.quantile(·, 0.5), which averages the two middle values of
an even count as jnp.median does (torch.median takes the lower one).
"""

from __future__ import annotations

from typing import Optional

import torch

from posteriflow_torch.models.npe import LeanNPE
from posteriflow_torch.physics.simulator import EventBatch

DIST_IDX = 2     # luminosity_distance in PARAM_NAMES


def coverage(samples: torch.Tensor, theta0: torch.Tensor, live: torch.Tensor,
             n_live: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """[P] share of live events whose truth lies in the [lo, hi] quantile
    interval of its draws samples [n, n_post, P]."""
    q_lo = torch.quantile(samples, lo, dim=1)
    q_hi = torch.quantile(samples, hi, dim=1)
    inside = ((theta0 >= q_lo) & (theta0 <= q_hi)).float()
    return torch.sum(inside * live[:, None], dim=0) / n_live


def make_diagnostics(cfg, n_events: int = 256, n_post: int = 128):
    """Returns diagnostics(model, batch, generator=None, perm=None, z=None)
    -> dict of floats (val_nll_diag, shuffle_delta_nll, dist_corr,
    dist_cov50, dist_cov90) and [P] numpy arrays (cov50_all, cov90_all),
    on the rank-0 (primary signal) labels only, like the reference."""

    def diagnostics(model: LeanNPE, batch: EventBatch,
                    generator: Optional[torch.Generator] = None,
                    perm: Optional[torch.Tensor] = None,
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
            nll_true = model.nll_from_context(ctx, theta0, rank0)
            if perm is None:
                perm = torch.randperm(n, generator=generator, device=dev)
            perm = perm.to(dev)
            nll_shuf = model.nll_from_context(ctx[perm], theta0, rank0)
            mean_true = torch.sum(nll_true * live) / n_live
            # pair mask: the event and its shuffled context's donor are live
            pair = live * live[perm]
            mean_shuf = (torch.sum(nll_shuf * pair)
                         / torch.clamp(torch.sum(pair), min=1.0))

            samples, _, _ = model.sample_from_context(
                ctx, rank0, n_post, generator=generator,
                z=None if z is None else z.to(dev))      # [n, n_post, P]
            cov50 = coverage(samples, theta0, live, n_live, 0.25, 0.75)
            cov90 = coverage(samples, theta0, live, n_live, 0.05, 0.95)

            d_med = torch.quantile(samples[:, :, DIST_IDX], 0.5, dim=1)
            x = torch.log(torch.clamp(d_med, min=1.0))
            y = torch.log(torch.clamp(theta0[:, DIST_IDX], min=1.0))
            xm = torch.sum(x * live) / n_live
            ym = torch.sum(y * live) / n_live
            cov_xy = torch.sum((x - xm) * (y - ym) * live) / n_live
            var_x = torch.sum((x - xm) ** 2 * live) / n_live
            var_y = torch.sum((y - ym) ** 2 * live) / n_live
            dist_corr = cov_xy / torch.sqrt(torch.clamp(var_x * var_y,
                                                        min=1e-12))
        return {
            "val_nll_diag": float(mean_true),
            "shuffle_delta_nll": float(mean_shuf - mean_true),
            "dist_corr": float(dist_corr),
            "dist_cov50": float(cov50[DIST_IDX]),
            "dist_cov90": float(cov90[DIST_IDX]),
            "cov50_all": cov50.cpu().numpy(),
            "cov90_all": cov90.cpu().numpy(),
        }

    return diagnostics
