"""Order per-rank posteriors into an extraction sequence (torch).

Port of posteriflow_tpu/inference/ranking.py: the per-rank posterior
medians -> 0.5 s whitened strain segments around each inferred merger
(numpy, on the host) and the physics expected SNR of each median (on the
engine's device) -> PriorityNet scores on that device, or the loudness
fallback when no net is found -> the order, by np.argsort on the host
as the JAX package sorts, so that ties break alike.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from posteriflow_torch.models.priority_net import (SEG_LEN, PriorityNet,
                                                   loudness_fallback)
from posteriflow_torch.physics.constants import DURATION, SAMPLE_RATE


def extract_segments(strain: np.ndarray, t_offs: np.ndarray) -> np.ndarray:
    """[3, T] whitened strain + per-candidate merger offsets [n] ->
    [n, 3, SEG_LEN] segments centred on each inferred merger."""
    t = strain.shape[-1]
    centers = ((np.asarray(t_offs) + DURATION / 2) * SAMPLE_RATE).astype(int)
    half = SEG_LEN // 2
    out = np.zeros((len(centers), strain.shape[0], SEG_LEN),
                   dtype=np.float32)
    for i, c in enumerate(centers):
        lo = np.clip(c - half, 0, t - SEG_LEN)
        out[i] = strain[:, lo:lo + SEG_LEN]
    return out


# the released nets, newest first (paths relative to the repository root)
_DEFAULT_NET_PATHS = (
    Path("model_release/priority_v7/priority_params.msgpack"),
    Path("model_release/priority_v5/priority_params.msgpack"),
    Path("model/priority_v5/priority_params.msgpack"),
)


def _default_priority_net(device) -> Optional[PriorityNet]:
    """The repository's newest released PriorityNet on `device`, or None
    when none is present."""
    for p in _DEFAULT_NET_PATHS:
        if p.exists():
            from posteriflow_torch.train.train_priority import \
                load_priority_net
            return load_priority_net(p, device=device)
    return None


def rank_overlapping(results: List, strain: np.ndarray,
                     priority_model: Optional[PriorityNet] = None,
                     use_default_net: bool = True, device="cuda"):
    """results: per-rank PosteriorResults; strain: [3, T] whitened.

    Returns (order, scores): order[i] = index into `results` of the i-th
    highest-priority candidate. Uses, in order: `priority_model`, the
    repository's released net (use_default_net) on `device`, else the
    loudness-proxy fallback."""
    medians = np.stack([r.median() for r in results])          # [n, P]
    segs = extract_segments(strain, medians[:, 8])

    if priority_model is None and use_default_net:
        priority_model = _default_priority_net(device)

    if priority_model is not None:
        dev = next(priority_model.parameters()).device
        med = torch.as_tensor(medians, dtype=torch.float32, device=dev)
        snr_est = None
        with torch.no_grad():
            if priority_model.use_snr_est:
                from posteriflow_torch.physics.simulator import (
                    design_asd, signal_snr_amp_only)
                snr_est = signal_snr_amp_only(med, design_asd(dev))[None]
            mask = torch.ones((1, len(results)), device=dev)
            scores, _sigma = priority_model(
                torch.as_tensor(segs, device=dev)[None], med[None], mask,
                snr_est=snr_est)
        scores = scores[0].cpu().numpy()
    else:
        scores = loudness_fallback(torch.as_tensor(
            medians, dtype=torch.float32)).numpy()

    order = np.argsort(-scores)
    return order.tolist(), scores.tolist()
