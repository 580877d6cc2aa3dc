"""Package a long-BNS run directory as a release (+ meta.json).

The port's twin of scripts/release_long_bns_v2.py. The run directory is a
port run (tools/train_long_bns.py: state.pt, history.json,
calibration.json) or a JAX one (params.msgpack in place of state.pt). Its
model is loaded (train/checkpoints.load_long_bns, on the CPU) and its
weights written as flax writes them (state_dict_to_flax + msgpack_lite's
packb), so the JAX package reads the release; history.json and
calibration.json are copied (and a v4 run's grid.npz, which the port
serves it on), and meta.json records JAX's keys: the model
class from the tokens' kind, the run's config, the last history record,
the steps trained, --init-from, the gate report and whether it passed,
and the export time. A report with failing gates refuses the release
(exit 1). The default --out is the port's own directory, never
model_release/.

    python -m posteriflow_torch.tools.release_long_bns --run model/lbns \\
        --out model/lbns_release --report reports/val_lbns_torch
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from datetime import datetime, timezone
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--run", default="model/long_bns_v2")
    ap.add_argument("--out", default="model/long_bns_v2_release")
    ap.add_argument("--report", default="reports/val_long_bns")
    ap.add_argument(
        "--init-from",
        default="model/long_bns_v2 step-700 smoke (same run dir, "
                "fresh opt state on resume)",
        help="provenance string: what checkpoint the run warm-started from")
    args = ap.parse_args(argv)

    from posteriflow_torch.train.checkpoints import (load_long_bns,
                                                     write_params)

    run = Path(args.run)
    out = Path(args.out)
    report = Path(args.report) / "report.json"

    cal = json.loads((run / "calibration.json").read_text())
    history = json.loads((run / "history.json").read_text())
    gates = json.loads(report.read_text()) if report.exists() else None
    if gates is not None and not gates.get("passed"):
        print(f"refusing to release: {report} has failing gates",
              file=sys.stderr)
        return 1

    model, _, _ = load_long_bns(run, device="cpu")
    out.mkdir(parents=True, exist_ok=True)
    write_params(model, out / "params.msgpack")
    for f in ("history.json", "calibration.json", "grid.npz"):
        if f == "grid.npz" and not (run / f).is_file():
            continue
        shutil.copy2(run / f, out / f)

    is_v4 = (cal["config"].get("tokens", {}).get("kind") == "trigger")
    meta = {
        "model": "LongBNSNPEv4" if is_v4 else "LongBNSNPE",
        "config": cal["config"],
        "final": history[-1],
        "trained_steps": history[-1]["step"],
        "init_from": args.init_from,
        "gate_battery": str(report) if gates is not None else "PENDING",
        "gates_all_passed": None if gates is None else gates["passed"],
        "exported_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    print(f"released {out} (steps={meta['trained_steps']}, "
          f"gates={'PENDING' if gates is None else gates['passed']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
