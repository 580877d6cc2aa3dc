"""Controlled experiment: a frozen encoder and several posterior heads
trained on identical contexts, to attribute bias to the encoder or the
flow.

The port's twin of scripts/frozen_context_heads.py. Heads: a coupling NSF
(4 layers, hidden 64, K = 8), a larger one (8 layers, hidden 128, K = 8)
and an 8-component Gaussian mixture density head, each trained with Adam
at 1e-3 on the frozen release's contexts of freshly simulated events
(rank-0 parameters, normalized; dead events masked), from flax's default
initializers. If the heads' final NLLs agree (spread < 0.5 nats) the
encoder is the bottleneck, otherwise the head. On a card the NSF heads run
the spline kernels (rqs_tile<8> forward, rqs_grad<8> backward). --ckpt is
a CheckpointManager root or a release directory.

Usage:
  python -m posteriflow_torch.tools.frozen_context_heads --ckpt DIR --steps 300
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch
from torch import nn

from posteriflow_torch.models.flow import CouplingNSF, gelu
from posteriflow_torch.utils.precision import fp32_exact

HEADS = ("nsf_small", "nsf_large", "mdn")


class MDNHead(nn.Module):
    """An n_comp-component diagonal Gaussian mixture over the normalized
    parameters given the context: two tanh-GELU layers of 128, then the
    mixture logits, means and softplus widths (+1e-3). Module names are
    flax's auto-names (Dense_0..Dense_4). forward -> NLL [B]."""

    def __init__(self, ctx_dim: int, n_params: int, n_comp: int = 8):
        super().__init__()
        self.n_comp, self.n_params = n_comp, n_params
        self.Dense_0 = nn.Linear(ctx_dim, 128)
        self.Dense_1 = nn.Linear(128, 128)
        self.Dense_2 = nn.Linear(128, n_comp)
        self.Dense_3 = nn.Linear(128, n_comp * n_params)
        self.Dense_4 = nn.Linear(128, n_comp * n_params)

    def forward(self, ctx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with fp32_exact():
            h = gelu(self.Dense_0(ctx))
            h = gelu(self.Dense_1(h))
            logits = self.Dense_2(h)
            mu = self.Dense_3(h).reshape(-1, self.n_comp, self.n_params)
            sig = torch.nn.functional.softplus(self.Dense_4(h)).reshape(
                -1, self.n_comp, self.n_params) + 1e-3
        comp_lp = (-0.5 * torch.sum(((y[:, None] - mu) / sig) ** 2, -1)
                   - torch.sum(torch.log(sig), -1)
                   - 0.5 * self.n_params * math.log(2 * math.pi))
        return -torch.logsumexp(torch.log_softmax(logits, dim=-1) + comp_lp,
                                dim=-1)


class FlowHead(nn.Module):
    """A coupling NSF (K = 8, the conditioner in bfloat16 as flax's
    default) over the normalized parameters; forward -> NLL [B]."""

    def __init__(self, ctx_dim: int, n_params: int, layers: int = 4,
                 hidden: int = 64):
        super().__init__()
        self.flow = CouplingNSF(features=n_params, context_features=ctx_dim,
                                num_layers=layers, hidden=hidden, num_bins=8)

    def forward(self, ctx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return -self.flow.log_prob(y, ctx)


def make_head(name: str, ctx_dim: int, n_params: int) -> nn.Module:
    if name == "mdn":
        return MDNHead(ctx_dim, n_params)
    layers, hidden = {"nsf_small": (4, 64), "nsf_large": (8, 128)}[name]
    return FlowHead(ctx_dim, n_params, layers, hidden)


def masked_nll(head: nn.Module, ctx, y, live) -> torch.Tensor:
    """The mean NLL over live events."""
    nll = head(ctx, y)
    return torch.sum(nll * live) / torch.clamp_min(torch.sum(live), 1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--name", default="best")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/frozen_context_heads.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from posteriflow_torch.utils.logging import setup_logging
    log = setup_logging()

    from posteriflow_torch.physics.simulator import simulate_batch
    from posteriflow_torch.train.checkpoints import load_npe
    from posteriflow_torch.train.trainer import init_params

    dev = torch.device(args.device)
    model, cfg = load_npe(args.ckpt, args.name, dev)
    for p in model.parameters():
        p.requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def make_batch():
        """(frozen contexts, normalized rank-0 params, live mask)."""
        with torch.no_grad():
            b = simulate_batch(args.batch, cfg.sim, device=dev,
                               generator=gen)
            asd = b.asd_bands if cfg.npe.uses_asd_bands else None
            ctx = model.encode(b.strain, asd).float()
            y = model.scaler.normalize(b.params[:, 0, :])
            live = (b.n_sig > 0).float()
        return ctx, y, live

    results = {}
    for name in HEADS:
        head = make_head(name, cfg.npe.context_dim, cfg.npe.n_params)
        init_params(head, torch.Generator().manual_seed(args.seed + 1))
        head.to(dev)
        opt = torch.optim.Adam(head.parameters(), lr=1e-3)
        losses = []
        for _ in range(args.steps):
            ctx, y, live = make_batch()
            loss = masked_nll(head, ctx, y, live)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        results[name] = {"initial_nll": float(np.mean(losses[:20])),
                         "final_nll": float(np.mean(losses[-20:]))}
        log.info("%-10s NLL %.3f -> %.3f", name,
                 results[name]["initial_nll"], results[name]["final_nll"])

    spread = (max(r["final_nll"] for r in results.values())
              - min(r["final_nll"] for r in results.values()))
    report = {"heads": results, "final_nll_spread": spread,
              "interpretation": ("heads agree -> encoder-limited"
                                 if spread < 0.5 else
                                 "heads diverge -> head-limited"),
              "steps": args.steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    log.info("spread %.3f: %s", spread, report["interpretation"])
    return report


if __name__ == "__main__":
    main()
