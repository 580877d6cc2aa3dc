"""The subtract-and-reinfer loop batched over many events on one device
(torch).

Port of posteriflow_tpu/core/pod.py: every stage runs over the whole
batch of B events (encode → rank-0 draws through the
flow, whose spline runs in the CUDA kernel on a card → the posterior-mean
template of each event's first draws → least-squares subtraction), and an
event that fails the quality gate freezes by masking instead of leaving
the loop. The stage median is `torch.quantile(·, 0.5)`, which averages the
two middle values as jnp.median does (torch.median takes the lower one).
With a mesh each rank decomposes its rows along "data" and the results
are gathered, as the JAX package shards the batch over the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from posteriflow_torch.core.subtractor import ls_fit
from posteriflow_torch.inference.importance import data_white_fd
from posteriflow_torch.models.npe import LeanNPE
from posteriflow_torch.parallel.mesh import all_gather_seq, shard_rows
from posteriflow_torch.physics.constants import N_SAMPLES
from posteriflow_torch.physics.simulator import design_asd, signal_white_fd
from posteriflow_torch.physics.whiten import fd_white_to_td


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks of x concatenated in rank order (bool as
    uint8 on the wire)."""
    if x.dtype == torch.bool:
        return all_gather_seq(x.to(torch.uint8), group, dim=0).bool()
    return all_gather_seq(x, group, dim=0)


def make_batched_decompose(cfg, n_samples: int = 1024, max_stages: int = 3,
                           quality_threshold: float = 0.3,
                           n_template_draws: int = 128, mesh=None):
    """cfg: a TrainConfig (its `npe` part is read). Returns
    decompose(model, strain [B, 3, T], asd_bands [B, 3, K], generator=None,
    z=None) -> dict of per-stage results stacked on axis 1 ([B, n_stages,
    ...]) plus n_extracted [B] and final_residual [B, 3, T]. Stage s draws
    its base samples [B, n_samples, P] from `generator`, or takes z[s].

    mesh: a DeviceMesh (parallel/mesh.py). Each rank decomposes its rows
    along "data" of the events, with its rows of each stage's base draws
    (drawn for the whole batch, so a row's draws are the same on any
    mesh), and every rank returns the gathered, unsharded result."""
    group = None if mesh is None else mesh.get_group("data")
    uses_bands = cfg.npe.uses_asd_bands

    @torch.no_grad()
    def stage(model: LeanNPE, strain, asd_bands, active, generator, z_s):
        b = strain.shape[0]
        ctx = model.encode(strain, asd_bands if uses_bands else None)
        rank0 = torch.zeros((b,), dtype=torch.long, device=strain.device)
        theta, _, _ = model.sample_from_context(ctx, rank0, n_samples,
                                                generator=generator, z=z_s)
        draws = theta[:, :n_template_draws]
        h = signal_white_fd(draws.reshape(-1, draws.shape[-1]),
                            design_asd(strain.device))
        h_mean = torch.mean(h.reshape(b, draws.shape[1], *h.shape[1:]),
                            dim=1)                           # [B, 3, F]
        d_w = data_white_fd(strain)
        alpha, fit_snr, _, quality = ls_fit(d_w, h_mean)
        accepted = (quality > quality_threshold) & active
        resid_fd = d_w - (alpha * accepted)[:, None, None] * h_mean
        residual = fd_white_to_td(resid_fd, N_SAMPLES)
        strain_next = torch.where(accepted[:, None, None], residual, strain)
        med = torch.quantile(theta, 0.5, dim=1)              # [B, P]
        return strain_next, {"median": med, "fit_snr": fit_snr,
                             "alpha": alpha, "quality": quality,
                             "accepted": accepted}

    def decompose(model: LeanNPE, strain, asd_bands,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[Sequence[torch.Tensor]] = None):
        dev = next(model.parameters()).device
        strain = torch.as_tensor(strain, dtype=torch.float32, device=dev)
        asd_bands = torch.as_tensor(asd_bands, dtype=torch.float32,
                                    device=dev)
        b = strain.shape[0]
        rows = slice(None) if mesh is None else shard_rows(b, mesh)
        strain, asd_bands = strain[rows], asd_bands[rows]
        active = torch.ones((strain.shape[0],), dtype=torch.bool, device=dev)
        stages = []
        for s in range(max_stages):
            if z is not None:
                z_s = z[s].to(dev)[rows]
            elif mesh is not None:
                z_s = torch.randn((b, n_samples, cfg.npe.n_params),
                                  generator=generator, device=dev)[rows]
            else:
                z_s = None
            strain, rec = stage(model, strain, asd_bands, active, generator,
                                z_s)
            active = rec["accepted"]
            stages.append(rec)
        out = {k: torch.stack([r[k] for r in stages], dim=1)
               for k in stages[0]}
        out["n_extracted"] = torch.sum(out["accepted"].to(torch.int32),
                                       dim=1)
        out["final_residual"] = strain
        if group is not None:
            out = {k: _gather_rows(v, group) for k, v in out.items()}
        return out

    return decompose
