"""Export a port training checkpoint as a release directory that both
packages load (the twin of scripts/export_release.py).

A release is params.msgpack (the flax parameter tree, byte for byte what
flax.serialization.to_bytes writes: train/checkpoints.state_dict_to_flax
and utils/msgpack_lite.packb), meta.json (the whole TrainConfig, the
epoch and the metrics, JAX's keys), history.json from --run-dir and
ood_stats.npz (tools/validate_checkpoint.py writes it beside the
checkpoints; a warning if it is missing). The weights are re-packed on
the host; the export is then loaded back onto --device (default cuda)
with CheckpointManager.load_release, the check that it rebuilds.

    python -m posteriflow_torch.tools.export_release --ckpt model/ft/ckpt \\
        --run-dir model/ft --out model/ft_release [--init-from RELEASE]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt", required=True, help="CheckpointManager root")
    ap.add_argument("--name", default="best")
    ap.add_argument("--run-dir", default=None,
                    help="training run directory holding history.json")
    ap.add_argument("--out", required=True, help="release directory to write")
    ap.add_argument("--init-from", default=None,
                    help="warm-restart parent checkpoint or release "
                         "(provenance, when the run's meta lacks it)")
    ap.add_argument("--device", default="cuda",
                    help="where the round-trip check loads the export")
    args = ap.parse_args(argv)

    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                     load_checkpoint_model,
                                                     write_params)
    from posteriflow_torch.models.npe import LeanNPE

    state_dict, cfg, meta = load_checkpoint_model(args.ckpt, args.name)
    model = LeanNPE(cfg.npe)
    model.load_state_dict(state_dict, strict=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    write_params(model, out / "params.msgpack")
    if args.init_from:
        meta.setdefault("metrics", {})["init_from"] = args.init_from
    (out / "meta.json").write_text(json.dumps(meta, indent=1))

    ood = Path(args.ckpt) / "ood_stats.npz"
    if ood.exists():
        shutil.copy(ood, out / "ood_stats.npz")
    else:
        print(f"WARNING: {ood} missing — run validate_checkpoint first "
              "so the release ships armed OOD statistics", file=sys.stderr)
    if args.run_dir:
        hist = Path(args.run_dir) / "history.json"
        if hist.exists():
            shutil.copy(hist, out / "history.json")

    model2, cfg2, meta2 = CheckpointManager.load_release(out,
                                                         device=args.device)
    n = sum(p.numel() for p in model2.parameters())
    print(f"release {out}: {n:,} params, epoch {meta2.get('epoch')}, "
          f"d_model {cfg2.npe.d_model}")
    return out


if __name__ == "__main__":
    main()
