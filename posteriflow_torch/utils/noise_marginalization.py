"""K-noise-realization loss grouping: E_θ[E_noise[NLL]].

Port of posteriflow_tpu/utils/noise_marginalization.py. When a batch holds
K noise realizations of each parameter set, the loss is averaged within
each θ-group first, so that every θ counts the same whatever its K. The
on-device simulator draws fresh noise every step (the K → ∞ limit); these
helpers serve offline datasets made with K > 1 and experiments that pair
noise draws.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def group_mean_loss(losses: torch.Tensor, group_ids: torch.Tensor,
                    n_groups: int) -> torch.Tensor:
    """Per-sample losses [N] with integer group ids [N] -> the mean over
    the groups that have members of their within-group means (sums by
    index_add_, as JAX's segment_sum; ids outside [0, n_groups) raise)."""
    sums = torch.zeros(n_groups, dtype=losses.dtype, device=losses.device)
    sums.index_add_(0, group_ids, losses)
    counts = torch.zeros_like(sums).index_add_(0, group_ids,
                                               torch.ones_like(losses))
    live = counts > 0
    means = torch.where(live, sums / torch.clamp(counts, min=1.0),
                        torch.zeros_like(sums))
    return torch.sum(means) / torch.clamp(live.sum(), min=1).to(sums.dtype)


def repeat_params_k_noise(seed: int, params: torch.Tensor, k: int,
                          ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """[B, ...] parameter sets -> ([B·K, ...] repeated params, [B·K] group
    ids, [B·K] per-copy noise seeds): the K-realizations-per-θ layout.

    JAX returns B·K keys split from one key; in the port a copy's "key" is
    an integer seed for its own generator (torch.Generator().manual_seed),
    drawn from numpy's SeedSequence of `seed`, so the copies' noise streams
    are independent and reproducible."""
    b = params.shape[0]
    rep = torch.repeat_interleave(params, k, dim=0)
    gids = torch.repeat_interleave(
        torch.arange(b, device=params.device), k)
    seeds = np.random.SeedSequence(seed).generate_state(
        b * k, np.uint64) >> np.uint64(1)
    return rep, gids, seeds
