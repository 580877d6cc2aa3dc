"""The plain reference of the LeanNPE training cells: the checked steps
from the same draws, and the gaps that decide `correct`.

The frozen copy's TrainState (pfbench/reference/frozen/train/trainer.py:
the plain spline differentiated by autograd, optax's clip and AdamW as
the port writes them) starts from the release's own files and takes one
step a batch that its own simulator makes from the benchmark's draws.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from pfbench.reference.frozen.data.noise_bank import RealNoiseDraws
from pfbench.reference.frozen.models.npe import LeanNPE
from pfbench.reference.frozen.physics.simulator import (RealDraws, SimDraws,
                                                        simulate_batch)
from pfbench.reference.frozen.train.checkpoints import (flax_to_state_dict,
                                                        train_cfg_from_dict)
from pfbench.reference.frozen.train.trainer import (TrainState,
                                                    make_optimizer,
                                                    train_step)
from pfbench.reference.frozen.utils.msgpack_lite import unpackb
from pfbench.reference.npe import leaf_gaps, lower_precision

ADAM_B1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
FLAT_LEAF = 1e-3


def steps(release_dir, cfg_dict: dict, sim, bank, draws: list, device,
          lower: bool = False) -> dict:
    """-> {"losses": [...], "grad_norms": {leaf: ‖g‖}, "change_norms":
    {leaf: ‖Δθ‖}} over the steps of `draws` (traffic.TrainDraws)."""
    cfg = train_cfg_from_dict(cfg_dict)
    model = LeanNPE(cfg.npe)
    release_dir = Path(release_dir)
    model.load_state_dict(flax_to_state_dict(unpackb(
        (release_dir / "params.msgpack").read_bytes())), strict=True)
    model.to(device)
    state = TrainState(model=model, opt=make_optimizer(cfg, model), cfg=cfg)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    losses, grad_norms = [], {}
    for k, d in enumerate(draws):
        batch = simulate_batch(
            cfg.batch_size, cfg.sim, device=device, params=d.params,
            n_sig=d.n_sig, draws=SimDraws(*d.draws), bank=bank,
            real_draws=RealDraws(d.use_u, RealNoiseDraws(*d.crop)))
        with lower_precision() if lower else contextlib.nullcontext():
            m = train_step(state, batch)
        losses.append(float(m["nll"]))
        if k == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(mu)
                                   / (1.0 - ADAM_B1))
                          for n, mu in zip(names, state.opt.mu)}
    change = {n: float(torch.linalg.vector_norm(p.detach() - s))
              for n, p, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def gaps(prog: dict, ref: dict) -> dict:
    """loss_gap: the worst step's |ΔNLL| over |NLL| or 1; grad_gap and
    change_gap: the worst leaf's gap of norms (npe.leaf_gaps), the change
    over the leaves whose reference gradient is not flat; with the worst
    leaves' names beside them."""
    loss = max(abs(a - b) / max(abs(b), 1.0)
               for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    ordered = sorted(g.values())
    median = ordered[len(ordered) // 2]
    moving = [k for k in g if g[k] >= FLAT_LEAF * median]
    grad = leaf_gaps(prog["grad_norms"], g, list(g))
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    worst_g = max(grad, key=grad.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": loss, "grad_gap": grad[worst_g],
            "change_gap": change[worst_c], "grad_leaf": worst_g,
            "change_leaf": worst_c, "flat_leaves": len(g) - len(moving),
            "losses": [prog["losses"], ref["losses"]]}
