"""Hierarchical-bias correction network (torch).

Port of posteriflow_tpu/core/bias_corrector.py: a residual MLP in the
scaler's normalized space predicts, per parameter, a correction, an
uncertainty and a variance scale for a posterior estimated on residual
data after earlier subtractions. `correct` shifts the cloud by the mean
correction and widens it by one uniform factor sqrt(mean(vscale)), which
keeps its correlations; bounds are the scaler's box, the circular wrap
and the mass ordering. `fit_synthetic` trains it on simulator-derived
(estimate, truth) pairs with a stage-dependent corruption; `validate`
reports pre/post bias and z-score spread.

Module names are the flax names (`ResidualMLP_0.Dense_{i}`, `corr`,
`sigma`, `vscale`); `BiasCorrector.from_flax` carries a JAX parameter
tree across.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posteriflow_torch import N_PARAMS
from posteriflow_torch.scaler import ParamScaler


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class ResidualMLP(nn.Module):
    def __init__(self, d_in: int, hidden: int = 128, n_blocks: int = 3):
        super().__init__()
        self.n_blocks = n_blocks
        self.Dense_0 = nn.Linear(d_in, hidden)
        for i in range(2 * n_blocks):
            setattr(self, f"Dense_{i + 1}", nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _gelu(self.Dense_0(x))
        for i in range(self.n_blocks):
            r = _gelu(getattr(self, f"Dense_{2 * i + 1}")(h))
            r = getattr(self, f"Dense_{2 * i + 2}")(r)
            h = _gelu(h + r)
        return h


class BiasEstimator(nn.Module):
    """(normalized params [N, P], stage features [N, 4]) -> (correction,
    uncertainty, variance scale) [N, P] each."""

    def __init__(self, hidden: int = 128, n_params: int = N_PARAMS,
                 stage_feats: int = 4):
        super().__init__()
        self.ResidualMLP_0 = ResidualMLP(n_params + stage_feats, hidden)
        self.corr = nn.Linear(hidden, n_params)
        self.sigma = nn.Linear(hidden, n_params)
        self.vscale = nn.Linear(hidden, n_params)

    def forward(self, y_params: torch.Tensor, stage_feats: torch.Tensor):
        h = self.ResidualMLP_0(torch.cat([y_params, stage_feats], dim=-1))
        corr = 0.2 * torch.tanh(self.corr(h))
        sigma = F.softplus(self.sigma(h)) + 1e-3
        vscale = 1.0 + F.softplus(self.vscale(h))
        return corr, sigma, vscale


class BiasCorrector:
    """Applies a trained BiasEstimator to a posterior estimated on residual
    data. Without weights (neither `init`, `from_flax`, a state_dict nor
    `fit_synthetic`) `correct` returns the samples unchanged."""

    STAGE_FEATS = 4   # (stage index, quality, alpha, residual power ratio)

    def __init__(self, state_dict=None, scaler: Optional[ParamScaler] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.scaler = scaler or ParamScaler()
        # one output a parameter of the scaler (N_PARAMS with the default)
        self.model = BiasEstimator(
            n_params=len(self.scaler.param_names)).to(self.device)
        self.ready = state_dict is not None
        if self.ready:
            self.model.load_state_dict(state_dict, strict=True)

    @classmethod
    def from_flax(cls, tree: dict, scaler: Optional[ParamScaler] = None,
                  device="cuda") -> "BiasCorrector":
        """A corrector with the weights of a flax BiasEstimator tree (JAX's
        `BiasCorrector.init` or its trained params)."""
        from posteriflow_torch.train.checkpoints import flax_to_state_dict
        return cls(flax_to_state_dict(tree), scaler, device)

    def init(self, generator: Optional[torch.Generator] = None):
        """flax's default initializers (lecun-normal kernels, zero
        biases), drawn on the CPU."""
        from posteriflow_torch.train.trainer import init_params
        self.model.cpu()
        init_params(self.model, generator)
        self.model.to(self.device)
        self.ready = True
        return self.model

    @torch.no_grad()
    def correct(self, samples: np.ndarray, stage: int, quality: float,
                alpha: float, residual_ratio: float) -> Dict:
        """samples [N, P] physical -> corrected physical samples with
        variance inflation; bounds enforced by the scaler box."""
        if not self.ready:
            return {"samples": samples, "applied": False}
        y = self.scaler.normalize(torch.as_tensor(
            samples, dtype=torch.float32, device=self.device))
        feats = torch.tensor([[float(stage), quality, alpha,
                               residual_ratio]], dtype=torch.float32,
                             device=self.device).expand(y.shape[0], -1)
        corr, _sigma, vscale = self.model(y, feats)
        mean = torch.mean(y, dim=0, keepdim=True)
        # a uniform rescale of the centred cloud keeps its correlations
        inflate = torch.sqrt(torch.mean(vscale))
        y_new = mean + (y - mean) * inflate + torch.mean(corr, dim=0,
                                                         keepdim=True)
        out = self.scaler.denormalize(self.scaler.wrap(y_new)).cpu().numpy()
        m1 = np.maximum(out[:, 0], out[:, 1])
        m2 = np.minimum(out[:, 0], out[:, 1])
        out[:, 0], out[:, 1] = m1, m2
        return {"samples": out, "applied": True,
                "mean_correction": torch.mean(corr, dim=0).cpu().numpy(),
                "mean_vscale": torch.mean(vscale, dim=0).cpu().numpy()}

    def make_loss(self):
        """loss(y_est, stage_feats, y_true): the Gaussian NLL of the true
        normalized params under the corrected estimate."""
        model = self.model

        def loss_fn(y_est, stage_feats, y_true):
            corr, sigma, _ = model(y_est, stage_feats)
            err = (y_est + corr) - y_true
            return torch.mean(0.5 * (err / sigma) ** 2 + torch.log(sigma))

        return loss_fn

    def fit_synthetic(self, rng: Optional[np.random.Generator] = None,
                      n_events: int = 4096, n_steps: int = 500,
                      lr: float = 1e-3) -> float:
        """Full-batch Adam (constant lr) on simulator-derived pairs: BBH
        prior draws are the truths; the estimates carry a stage- and
        quality-dependent corruption (m1 pulled down, m2 up, distance
        inflated, noisier at later stages), all drawn from `rng` (numpy,
        default seed 0). Returns the final loss."""
        from posteriflow_torch.prior import sample_prior_bbh
        from posteriflow_torch.train.trainer import adam_update_

        rng = rng if rng is not None else np.random.default_rng(0)
        theta = sample_prior_bbh(rng, n_events)
        dev = self.device
        y_true = self.scaler.normalize(torch.as_tensor(
            theta, dtype=torch.float32)).numpy()
        stage = rng.integers(1, 4, n_events).astype(np.float32)
        quality = rng.uniform(0.3, 1.0, n_events).astype(np.float32)
        alpha = rng.uniform(0.5, 1.0, n_events).astype(np.float32)
        rpow = rng.uniform(0.2, 1.2, n_events).astype(np.float32)
        feats = np.stack([stage, quality, alpha, rpow], axis=1)
        amp = (0.03 * stage * (1.2 - quality))[:, None]
        bias = np.zeros_like(y_true)
        bias[:, 0], bias[:, 1], bias[:, 2] = -1.0, 1.0, 0.8
        y_est = (y_true + amp * bias + 0.02 * stage[:, None]
                 * rng.standard_normal(y_true.shape)).astype(np.float32)

        if not self.ready:
            self.init(torch.Generator().manual_seed(0))
        loss_fn = self.make_loss()
        params = list(self.model.parameters())
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        ye, f, yt = (torch.as_tensor(a, device=dev)
                     for a in (y_est, feats, y_true))
        loss = None
        for t in range(1, n_steps + 1):
            loss = loss_fn(ye, f, yt)
            # the vscale head is not in the loss: its gradient is zero
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(
                         loss, params, allow_unused=True))]
            adam_update_(params, grads, mu, nu, t, lr)
        return loss.item()

    @torch.no_grad()
    def validate(self, y_est: np.ndarray, stage_feats: np.ndarray,
                 y_true: np.ndarray) -> Dict:
        """Pre/post correction mean absolute bias per parameter and the
        z-score spread of the corrected estimates (1 = honest widths) on
        held-out normalized (estimate, truth) pairs."""
        dev = self.device
        corr, sigma, _ = self.model(
            torch.as_tensor(y_est, dtype=torch.float32, device=dev),
            torch.as_tensor(stage_feats, dtype=torch.float32, device=dev))
        corr, sigma = corr.cpu().numpy(), sigma.cpu().numpy()
        pre = np.abs(y_est - y_true).mean(axis=0)
        post = np.abs(y_est + corr - y_true).mean(axis=0)
        z = (y_est + corr - y_true) / sigma
        return {"pre_abs_bias": pre, "post_abs_bias": post,
                "improved_frac": float(np.mean(post < pre)),
                "z_std": np.std(z, axis=0)}
