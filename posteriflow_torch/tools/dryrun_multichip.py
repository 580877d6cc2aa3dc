"""One real data-parallel training step over N ranks at the tiny flagship
config: the port's twin of __graft_entry__.dryrun_multichip.

The step is the full one (simulate the global batch's rows on each rank,
encode, per-rank NLL, backward, the gradients summed over "data", clip,
AdamW) on a ('data' N, 'model' 1) mesh, and rank 0 prints its NLL and
gradient norm as the JAX function does. With --device cuda each rank
takes one card (NCCL) and N may not exceed the card count; with --device
cpu the ranks are gloo processes.

    python -m posteriflow_torch.tools.dryrun_multichip 4
    python -m posteriflow_torch.tools.dryrun_multichip 8 --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch


def tiny_config():
    """__graft_entry__._flagship_cfg(tiny=True): the 15-D precessing stack
    at d_model 32, 2 flow layers of 32, K = 4, batch 8."""
    from posteriflow_torch import PARAM_NAMES_PRECESSING
    from posteriflow_torch.models.npe import NPEConfig
    from posteriflow_torch.physics.simulator import SimConfig
    from posteriflow_torch.prior import PriorConfig
    from posteriflow_torch.train.trainer import TrainConfig
    npe = NPEConfig(param_names=PARAM_NAMES_PRECESSING, context_dim=32,
                    rank_dim=8, flow_layers=2, flow_hidden=32, flow_bins=4,
                    encoder_type="coherent", d_model=32, enc_layers=1,
                    enc_heads=4)
    sim = SimConfig(prior=PriorConfig(max_signals=2, precessing=True),
                    det_dropout=0.1, glitch_prob=0.05)
    return TrainConfig(npe=npe, sim=sim, batch_size=8, warmup_steps=2,
                       total_steps=10)


def rank_step(rank: int, n: int, device: str, out=None):
    """One rank's part: the mesh, a fresh state from seed 0, one step from
    a generator seeded 1. Rank 0 prints; `out` (a path) gets its metrics
    as JSON."""
    import json

    from posteriflow_torch.parallel.mesh import make_mesh
    from posteriflow_torch.train.trainer import init_state, make_train_step

    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    cfg = tiny_config()
    mesh = make_mesh(n)
    state = init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_train_step(cfg, mesh=mesh)
    m = step(state, torch.Generator(device=dev).manual_seed(1))
    nll, gn = float(m["nll"]), float(m["grad_norm"])
    if not math.isfinite(nll):
        raise RuntimeError(f"dryrun_multichip({n}): nll {nll}")
    if rank == 0:
        print(f"dryrun_multichip({n}): nll={nll:.4f} grad_norm={gn:.3f}",
              flush=True)
        if out:
            with open(out, "w") as f:
                json.dump({"nll": nll, "grad_norm": gn}, f)


def dryrun_multichip(n_devices: int, device: str = "cuda", out=None):
    """One step over n_devices ranks, spawned here (parallel/mesh.run_ranks)
    or, under torchrun, this process's rank of them; raises on "cuda" when
    n_devices exceeds the card count."""
    import torch.distributed as dist

    from posteriflow_torch.parallel.mesh import init_distributed, run_ranks
    if not run_ranks(rank_step, n_devices, device,
                     (n_devices, device, out)):
        init_distributed(device=device)
        rank_step(dist.get_rank(), n_devices, device, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="write rank 0's metrics to this JSON file")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.out)


if __name__ == "__main__":
    main()
