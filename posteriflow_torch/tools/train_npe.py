"""Train LeanNPE with the port (the twin of scripts/train_npe.py): batches
are simulated on the device every step, nothing is read from disk.

    python -m posteriflow_torch.tools.train_npe --outdir model/run1 --epochs 60
    python -m posteriflow_torch.tools.train_npe \\
        --config model_release/npe_r7_best/meta.json --outdir model/ft \\
        --init-from model_release/npe_r7_best --noise-bank data/noise_bank
    python -m posteriflow_torch.tools.train_npe --device cpu --config tiny.json \\
        --outdir /tmp/run --epochs 1 --steps-per-epoch 2 --batch 4

    python -m posteriflow_torch.tools.train_npe --config configs/npe_r6.yaml \\
        --init-from model_release/npe_r7_best --outdir model/ft \\
        --profile-dir model/ft/trace

--config takes a YAML TrainConfig (overrides of its defaults, as
configs/*.yaml), a JSON one, a release's meta.json or a release directory.
--encoder, --premerger, --psd-cond and --det-dropout override the model
and simulator config as the JAX script's do. --noise-bank loads a bank
directory (tools/make_noise_bank.py writes one) onto the device: training
mixes in its real noise with the config's real_noise_prob (0.5 if that is
not positive) and validates on a real-noise batch too. A real_noise_prob
above 0 without a bank is an error, as in the JAX script. --profile-dir
writes a torch.profiler trace of the first epoch to <dir>/trace.json.
--mesh shards each step over all visible ranks along "data"
(parallel/mesh.py; fit(mesh=)): under torchrun one rank a process, as
torchrun sets them; without a launcher it spawns one rank per visible card
(one gloo rank with --device cpu). Rank 0 writes the run. The JAX
script's --prng picks JAX's bit generator, which torch has no counterpart
of, so it is not taken.

    torchrun --nproc-per-node 4 -m posteriflow_torch.tools.train_npe \
        --mesh --config configs/npe_r6.yaml --outdir model/dp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from pathlib import Path


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", help="YAML or JSON TrainConfig, a "
                                     "release's meta.json or a release "
                                     "directory")
    ap.add_argument("--outdir", default="model/lean_npe")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--steps-per-epoch", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--encoder", choices=("conv", "coherent"), default=None)
    ap.add_argument("--premerger", action="store_true")
    ap.add_argument("--det-dropout", type=float, default=None)
    ap.add_argument("--psd-cond", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="load weights (a release or a checkpoint), FRESH "
                         "optimizer (fine-tune)")
    ap.add_argument("--resume-from", default=None,
                    help="restore the whole state (weights, optimizer, "
                         "schedule step) of a checkpoint: no LR restart")
    ap.add_argument("--noise-bank", default=None,
                    help="real-noise bank directory (see "
                         "tools/make_noise_bank.py); enables real-noise "
                         "mixing and the real-noise validation domain")
    ap.add_argument("--real-noise-prob", type=float, default=None,
                    help="per-event probability of a real-noise crop")
    ap.add_argument("--grad-clip-mode", choices=("global", "agc"),
                    default=None)
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="threshold for global mode / x0.01 factor for agc")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the step over all visible devices")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the first epoch "
                         "to <dir>/trace.json")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Train; returns the run's history (rank 0's, read back from
    history.json, when --mesh spawned the ranks)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh:
        import torch

        from posteriflow_torch.parallel.mesh import run_ranks
        n = (torch.cuda.device_count()
             if torch.device(args.device).type == "cuda" else 1)
        if run_ranks(_mesh_rank, n, args.device, (argv,)):
            return json.loads((Path(args.outdir) / "history.json")
                              .read_text())
    return _train(ap, args)


def _mesh_rank(rank: int, argv):
    ap = _parser()
    _train(ap, ap.parse_args(argv))


def _train(ap, args):
    device, mesh = args.device, None
    if args.mesh:
        import torch

        from posteriflow_torch.parallel.mesh import (init_distributed,
                                                     make_mesh)
        init_distributed(device=args.device)
        mesh = make_mesh()
        if torch.device(args.device).type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        if mesh.get_rank() != 0:
            args.profile_dir = None

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from posteriflow_torch.train.loop import fit
    from posteriflow_torch.train.trainer import TrainConfig
    from posteriflow_torch.utils.config import load_config
    from posteriflow_torch.utils.logging import torch_trace

    cfg = load_config(args.config) if args.config else TrainConfig()
    npe, sim = cfg.npe, cfg.sim
    if args.encoder:
        npe = dataclasses.replace(npe, encoder_type=args.encoder)
    if args.premerger:
        npe = dataclasses.replace(npe, premerger=True)
    if args.psd_cond:
        npe = dataclasses.replace(npe, psd_cond=True)
    if args.det_dropout is not None:
        sim = dataclasses.replace(sim, det_dropout=args.det_dropout)
    if args.real_noise_prob is not None:
        sim = dataclasses.replace(sim, real_noise_prob=args.real_noise_prob)
    overrides = {"npe": npe, "sim": sim,
                 "total_steps": args.epochs * args.steps_per_epoch}
    for field, value in (("batch_size", args.batch), ("lr", args.lr),
                         ("grad_clip_mode", args.grad_clip_mode),
                         ("grad_clip", args.grad_clip)):
        if value is not None:
            overrides[field] = value
    cfg = dataclasses.replace(cfg, **overrides)

    bank = None
    if args.noise_bank:
        from posteriflow_torch.data.noise_bank import load_noise_bank
        bank = load_noise_bank(args.noise_bank, psd_bands=cfg.sim.psd_bands,
                               device=device)
        if cfg.sim.real_noise_prob <= 0.0:
            cfg = dataclasses.replace(
                cfg, sim=dataclasses.replace(cfg.sim, real_noise_prob=0.5))
        logging.getLogger("posteriflow.train").info(
            "noise bank: %s (%d segments/det, real_noise_prob=%.2f)",
            args.noise_bank, bank.n_segments, cfg.sim.real_noise_prob)
    elif cfg.sim.real_noise_prob > 0.0:
        ap.error("--real-noise-prob needs --noise-bank")
    with torch_trace(args.profile_dir, device) as trace:
        _, history = fit(cfg, args.outdir, epochs=args.epochs,
                         steps_per_epoch=args.steps_per_epoch,
                         seed=args.seed, ckpt_every=args.ckpt_every,
                         init_from=args.init_from,
                         resume_from=args.resume_from, device=device,
                         bank=bank,
                         on_epoch_end=trace and (lambda rec: trace.stop()),
                         mesh=mesh)
    return history


if __name__ == "__main__":
    main()
