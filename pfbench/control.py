"""The readings that a cell's limits are set from, on the card.

    python3 -m pfbench.control --workload <cell> --seeds 1 2 3 [--units N]
        [--program-only | --control-only] [--fault NAME] [--witness]

For each seed, in one process: the cell's set-up, N units of its traffic
(a short window at the cell's own sizes and load), then the program's
readings against the plain reference (the lower reading of each number)
and the control's: the reference one step of precision below the
configuration's, in the program's place (the upper reading). With
--fault, the program's readings with that fault of pfbench/faults.py
planted under the timed path. With --witness (a served cell), also the
reference in the configuration's precision on the CPU against the
reference on the card: a sound run with other rounding, which the
program's bit-equal readings cannot give. One JSON line a seed. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from pfbench.faults import FAULTS
from pfbench.harness import registry
from pfbench.harness.spans import Spans


def readings(cell, seed: int, units: int, device, program: bool = True,
             control: bool = True, fault: str = None,
             witness: bool = False) -> dict:
    drv = registry.driver_module(cell.driver).Driver(cell, seed, device,
                                                     Spans(device, False))
    t0 = time.perf_counter()
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        first = drv.setup()
        for i in range(first, first + units):
            drv.run_unit(i)
        drv.sync()
        if hasattr(drv, "after_window"):
            drv.after_window()
    out = {"seed": seed, "units": units, "fault": fault,
           "setup_and_units_s": time.perf_counter() - t0}
    drv.release()
    if program:
        out["program"] = drv.readings()
    if control:
        out["control"] = drv.readings(lower=True)
    if witness:
        t1 = time.perf_counter()
        out["witness"] = drv.readings(witness=True)
        out["witness_s"] = time.perf_counter() - t1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=8)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--control-only", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pfbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = registry.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.units,
                                  torch.device("cuda:0"),
                                  not args.control_only,
                                  not args.program_only, args.fault,
                                  args.witness)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
