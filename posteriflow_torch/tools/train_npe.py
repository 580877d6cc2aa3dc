"""Train LeanNPE with the port (the twin of scripts/train_npe.py): batches
are simulated on the device every step, nothing is read from disk.

    python -m posteriflow_torch.tools.train_npe --outdir model/run1 --epochs 60
    python -m posteriflow_torch.tools.train_npe \\
        --config model_release/npe_r7_best/meta.json --outdir model/ft \\
        --init-from model_release/npe_r7_best
    python -m posteriflow_torch.tools.train_npe --device cpu --config tiny.json \\
        --outdir /tmp/run --epochs 1 --steps-per-epoch 2 --batch 4

--config takes a JSON TrainConfig (or overrides of it), a release's
meta.json or a release directory. The noise bank, the mesh and the PRNG
choice of the JAX script wait for their slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", help="JSON TrainConfig, a release's "
                                     "meta.json or a release directory")
    ap.add_argument("--outdir", default="model/lean_npe")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--steps-per-epoch", type=int, default=200)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--init-from", default=None,
                    help="load weights (a release or a checkpoint), FRESH "
                         "optimizer (fine-tune)")
    ap.add_argument("--resume-from", default=None,
                    help="restore the whole state (weights, optimizer, "
                         "schedule step) of a checkpoint: no LR restart")
    ap.add_argument("--grad-clip-mode", choices=("global", "agc"),
                    default=None)
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="threshold for global mode / x0.01 factor for agc")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from posteriflow_torch.train.loop import fit
    from posteriflow_torch.train.trainer import TrainConfig
    from posteriflow_torch.utils.config import load_config

    cfg = load_config(args.config) if args.config else TrainConfig()
    overrides = {"total_steps": args.epochs * args.steps_per_epoch}
    for field, value in (("batch_size", args.batch), ("lr", args.lr),
                         ("grad_clip_mode", args.grad_clip_mode),
                         ("grad_clip", args.grad_clip)):
        if value is not None:
            overrides[field] = value
    cfg = dataclasses.replace(cfg, **overrides)
    _, history = fit(cfg, args.outdir, epochs=args.epochs,
                     steps_per_epoch=args.steps_per_epoch, seed=args.seed,
                     ckpt_every=args.ckpt_every, init_from=args.init_from,
                     resume_from=args.resume_from, device=args.device)
    return history


if __name__ == "__main__":
    main()
