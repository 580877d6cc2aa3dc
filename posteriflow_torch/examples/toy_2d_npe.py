"""Toy 2-D NPE: a chirp-mass / mass-ratio RealNVP flow on IMR injections
in Gaussian noise, the minimum end-to-end slice: simulate -> encode ->
flow -> NLL -> sample -> PP-plot, on one device, with fixed seeds.

The port's twin of examples/toy_2d_npe.py, on --device. The waveform is
the package-level `imr_polarizations` (PhenomD with matter effects), the
alias the JAX example means to import. θ = (Mc, q) is uniform on
[10, 40] × [0.4, 1]; each injection is a single-detector whitened h₊ at
600 Mpc, merging 2 s into the window, plus unit white noise. The model is
a tiny conv encoder (flax's NWC convolutions with VALID padding, tanh
GELU) and a 6-layer affine-coupling RealNVP on the two normalized
parameters; Adam at 1e-3. The uniform draws and the noise come from
`draw_toy` (a torch.Generator), split from `toy_batch`.

Run:  python -m posteriflow_torch.examples.toy_2d_npe [--steps 600] [--out /tmp/toy2d] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from posteriflow_torch.models.flow import gelu

MC_RANGE = (10.0, 40.0)
Q_RANGE = (0.4, 1.0)
CONVS = ((8, 64, 8), (16, 16, 4), (32, 8, 4))    # (features, kernel, stride)


def mc_q_to_masses(mc, q):
    m1 = mc * (1 + q) ** 0.2 / q ** 0.6
    return m1, q * m1


def draw_toy(batch: int, generator: Optional[torch.Generator] = None,
             device="cuda"):
    """(u [batch, 2] uniform, noise [batch, N_SAMPLES] standard normal)."""
    from posteriflow_torch.physics.constants import N_SAMPLES
    u = torch.rand((batch, 2), generator=generator, device=device)
    noise = torch.randn((batch, N_SAMPLES), generator=generator,
                        device=device)
    return u, noise


def toy_batch(u: torch.Tensor, noise: torch.Tensor):
    """θ from u -> (whitened strain [B, T] = the signal + noise, y [B, 2]
    normalized to [-1, 1])."""
    from posteriflow_torch.physics.constants import FREQS, N_SAMPLES
    from posteriflow_torch.physics.psd import aligo_psd, asd_from_psd
    from posteriflow_torch.physics.waveforms import imr_polarizations
    from posteriflow_torch.physics.whiten import fd_white_to_td, whiten_fd

    dev = u.device
    freqs = torch.as_tensor(np.asarray(FREQS, np.float32), device=dev)
    asd = asd_from_psd(aligo_psd(FREQS), device=dev)
    mc = MC_RANGE[0] + u[:, 0] * (MC_RANGE[1] - MC_RANGE[0])
    q = Q_RANGE[0] + u[:, 1] * (Q_RANGE[1] - Q_RANGE[0])
    m1, m2 = mc_q_to_masses(mc, q)
    zero = torch.zeros_like(mc)[:, None]
    with torch.no_grad():
        hp, _ = imr_polarizations(freqs, m1[:, None], m2[:, None], zero,
                                  zero, zero + 600.0, zero, zero)
        ang = (-2.0 * math.pi) * torch.remainder(freqs * 2.0, 1.0)
        h_w = whiten_fd(hp * torch.complex(torch.cos(ang), torch.sin(ang)),
                        asd)
        sig = fd_white_to_td(h_w, N_SAMPLES)
    theta = torch.stack([mc, q], dim=1)
    lo = torch.tensor([MC_RANGE[0], Q_RANGE[0]], device=dev)
    hi = torch.tensor([MC_RANGE[1], Q_RANGE[1]], device=dev)
    return sig + noise, 2 * (theta - lo) / (hi - lo) - 1


def simulate(batch: int, generator: Optional[torch.Generator] = None,
             device="cuda"):
    return toy_batch(*draw_toy(batch, generator, device))


class _Net(nn.Module):
    """flax Sequential([Dense(hidden), gelu, Dense(2)]), flax's layer
    names (layers_0, layers_2)."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.layers_0 = nn.Linear(n_in, hidden)
        self.layers_2 = nn.Linear(hidden, 2)

    def forward(self, x):
        return self.layers_2(gelu(self.layers_0(x)))


class ToyModel(nn.Module):
    """A tiny conv encoder + an n_layers RealNVP (affine coupling) on 2
    parameters. Module names are the flax example's (convs_i, proj,
    nets_i)."""

    def __init__(self, n_layers: int = 6, hidden: int = 64, ctx: int = 32,
                 n_samples: Optional[int] = None):
        super().__init__()
        from posteriflow_torch.physics.constants import N_SAMPLES
        self.n_layers = n_layers
        n = N_SAMPLES if n_samples is None else n_samples
        c_in = 1
        for i, (f, k, s) in enumerate(CONVS):
            self.add_module(f"convs_{i}", nn.Conv1d(c_in, f, k, stride=s))
            c_in, n = f, (n - k) // s + 1
        self.proj = nn.Linear(c_in * n, ctx)
        for i in range(n_layers):
            self.add_module(f"nets_{i}", _Net(1 + ctx, hidden))

    def encode(self, strain: torch.Tensor) -> torch.Tensor:
        h = torch.asinh(strain)[:, None, :]
        for i in range(len(CONVS)):
            h = gelu(getattr(self, f"convs_{i}")(h))
        # flax flattens [B, L, C] (channels last)
        return self.proj(h.transpose(1, 2).reshape(h.shape[0], -1))

    def _couple(self, i: int, a: torch.Tensor, ctx: torch.Tensor):
        out = getattr(self, f"nets_{i}")(torch.cat([a[:, None], ctx], -1))
        return torch.tanh(out[:, 0]), out[:, 1]      # bounded log-scale

    def forward_flow(self, y: torch.Tensor, ctx: torch.Tensor):
        """y -> (z, log|dz/dy|); the transformed coordinate alternates."""
        ld = torch.zeros(y.shape[0], device=y.device)
        a, b = y[:, 0], y[:, 1]
        for i in range(self.n_layers):
            s, t = self._couple(i, a, ctx)
            b = b * torch.exp(s) + t
            ld = ld + s
            a, b = b, a
        return torch.stack([a, b], dim=1), ld

    def inverse(self, z: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        a, b = z[:, 0], z[:, 1]
        for i in reversed(range(self.n_layers)):
            a, b = b, a
            s, t = self._couple(i, a, ctx)
            b = (b - t) * torch.exp(-s)
        return torch.stack([a, b], dim=1)

    def nll(self, strain: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        z, ld = self.forward_flow(y, self.encode(strain))
        return torch.mean(0.5 * torch.sum(z ** 2, dim=1) - ld
                          + math.log(2 * math.pi))

    def sample(self, strain: torch.Tensor, n: int,
               generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, n, 2] posterior draws; base draws z [B·n, 2] if given."""
        ctx = self.encode(strain)
        b = ctx.shape[0]
        if z is None:
            z = torch.randn((b * n, 2), generator=generator,
                            device=ctx.device)
        return self.inverse(z, ctx.repeat_interleave(n, dim=0)).reshape(
            b, n, 2)

    forward = nll


def train(steps: int = 600, batch: int = 64, seed: int = 0, device="cuda",
          log_every: int = 100):
    """-> (model, losses): Adam at 1e-3, a fresh batch a step."""
    from posteriflow_torch.train.trainer import init_params
    device = torch.device(device)
    model = ToyModel()
    init_params(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(seed)
    losses = []
    for i in range(steps):
        strain, y = simulate(batch, gen, device)
        loss = model.nll(strain, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1:4d}  nll {np.mean(losses[-log_every:]):.3f}")
    return model, losses


def calibration(model: ToyModel, seed: int = 0, n_events: int = 200,
                n_post: int = 256, device="cuda"):
    """(ranks [n_events, 2], coverage {0.5, 0.9}: [2]) on fresh events."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        strain, y_true = simulate(n_events, gen, device)
        samples = model.sample(strain, n_post, gen).cpu().numpy()
    y_true = y_true.cpu().numpy()
    ranks = np.sum(samples < y_true[:, None, :], axis=1)
    cov = {}
    for level in (0.5, 0.9):
        lo = np.quantile(samples, 0.5 - level / 2, axis=1)
        hi = np.quantile(samples, 0.5 + level / 2, axis=1)
        cov[level] = ((y_true >= lo) & (y_true <= hi)).mean(axis=0)
    return ranks, cov


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default="/tmp/toy2d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, losses = train(args.steps, args.batch, args.seed, args.device)
    ranks, cov = calibration(model, args.seed, device=args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    from posteriflow_torch.inference.plots import pp_plot
    pp_plot(ranks, None, 256, out / "pp.png", param_names=("Mc", "q"))
    summary = {"final_nll": float(np.mean(losses[-50:])),
               "initial_nll": float(np.mean(losses[:20])),
               "cov50": cov[0.5].tolist(), "cov90": cov[0.9].tolist()}
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
