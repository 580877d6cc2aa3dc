"""Run one cell of the benchmark once on the card this machine holds.

    python3 -m pfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's file (pfbench/workloads/<cell>.json)
names its configuration, driver and traffic. The run makes its inputs from
--seed, loads the release, warms up the cell's own shapes, measures for
--seconds, checks what the window produced against the plain reference
(pfbench/reference), and prints as its last line one JSON object: the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1. Each number compared is printed beside its limit as the last
lines of standard error.

Exit codes: 0 a result was printed; 3 no card, or fewer cards than the
cell asks for; 4 a module of the JAX stack was loaded; 5 two profiler
sessions held no kernel. Only 0 prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
THREADS = 2          # host threads of torch's own pools: one process, few


def _cache_dirs():
    """The program's kernel caches, at fixed paths inside the checkout."""
    cache = PKG / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    _cache_dirs()
    import torch
    torch.set_num_threads(THREADS)

    from pfbench.harness import registry, trace, window

    cell = registry.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("pfbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"pfbench: {cell.name} needs {cell.chips} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        result, checks = window.run_cell(cell, args.seed, args.seconds,
                                         bool(args.trace), "cuda:0", T0)
    except trace.EmptyTrace as e:
        print(f"pfbench: {e}; the run is failed", file=sys.stderr)
        return 5
    found = window.forbidden_modules()
    if found:
        print(f"pfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
