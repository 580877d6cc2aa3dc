"""The one generator of the benchmark's traffic: it reads a cell's
parameters and makes every input from --seed, on the device, with the
benchmark's own frozen copy of the simulator (pfbench/reference/frozen),
so that nothing the program computes feeds its own inputs. The same seed
gives the same inputs; every seed gives inputs of the same sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run: (seed, tags...)."""
    words = [t & (2**64 - 1) for t in (seed, *tags)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> 1)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


# stream tags: one a kind of draw, so that no two share a generator
POOL, BASE, TRAIN, BANK, CHECK, INIT = range(6)


def base_draws(seed: int, unit: int, shape, device) -> torch.Tensor:
    """The flow's standard-normal base draws of one request."""
    return torch.randn(shape, generator=generator(device, seed, BASE, unit),
                       device=device)


def npe_event_pool(sim: dict, n_events: int, seed: int, device):
    """n_events whitened 3-detector events of the configuration's
    simulator (Gaussian noise at design sensitivity) -> (strain [n, D, T],
    asd_bands [n, D, K]) as float32 numpy arrays on the host."""
    from pfbench.reference.frozen.physics.simulator import (
        sim_config_from_dict, simulate_batch)
    batch = simulate_batch(n_events, sim_config_from_dict(sim),
                           device=device,
                           generator=generator(device, seed, POOL))
    return (batch.strain.float().cpu().numpy(),
            batch.asd_bands.float().cpu().numpy())


def bank_draws(seed: int, n_segments: int, segment_len: int, device):
    """A synthetic real-noise bank's draws: unit white segments [D, n, L]
    float16 and each segment's sensitivity knots."""
    from pfbench.reference.frozen.data.noise_bank import draw_synthetic_bank
    return draw_synthetic_bank(generator(device, seed, BANK), n_segments,
                               segment_len, device=device)


class TrainDraws(NamedTuple):
    params: torch.Tensor      # [B, S, P] physical, from the prior
    n_sig: torch.Tensor       # [B]
    draws: tuple              # the simulator's SimDraws fields
    use_u: torch.Tensor       # [B] real noise if below real_noise_prob
    crop: tuple               # the bank's RealNoiseDraws fields


def train_draws(sim_cfg, bank, seed: int, step: int, batch: int,
                device) -> TrainDraws:
    """Every random draw of one training batch: the prior's parameters,
    the event draws and the real-noise draws on `bank` (the frozen copy's
    NoiseBank), from the step's own generator."""
    from pfbench.reference.frozen.data.noise_bank import draw_real_noise
    from pfbench.reference.frozen.physics.simulator import draw_events
    from pfbench.reference.frozen.prior import sample_batch
    gen = generator(device, seed, TRAIN, step)
    params, n_sig = sample_batch(batch, sim_cfg.prior, gen, device)
    draws = draw_events((batch,), gen, device)
    use_u = torch.rand((batch,), generator=gen, device=device)
    crop = draw_real_noise((batch,), bank, gen)
    return TrainDraws(params, n_sig, tuple(draws), use_u, tuple(crop))


def long_bns_pool(grid: dict, n_triggers: int, seed: int, device,
                  chunk: int = 250):
    """n_triggers long-BNS triggers of the frozen v4 simulator: whitened
    FD strain of the signal in design noise [n, D, cut] complex64 and the
    trigger [n, 1 + D] (M̂c, t̂ a detector) -> host tensors in ordinary
    (pageable) memory, as the LeanNPE pool is. Made `chunk` at a time."""
    from pfbench.reference.frozen.models import long_bns as lb
    gen = generator(device, seed, POOL)
    strains, trigs = [], []
    for start in range(0, n_triggers, chunk):
        n = min(chunk, n_triggers - start)
        d = lb.draw_long_bns(n, grid["cut"], grid["trunc"], gen, device)
        h_w = lb.white_signal(d.theta, grid["freqs"], grid["duration"])
        strains.append((h_w + d.noise).cpu())
        trigs.append(lb.trigger_of(d.theta, d.eps, grid).cpu())
    return torch.cat(strains), torch.cat(trigs)
