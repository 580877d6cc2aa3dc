"""Time the RQS kernel of csrc/rqs.cu against an earlier build of the same
kernel, in turns, on one CUDA card.

    python -m posteriflow_torch.tools.rqs_ab OLD.cu

OLD.cu is a copy of csrc/rqs.cu from before the derivative bias moved into
the kernel: its C launcher is pf_rqs_launch(x, raw, out, logdet, n, d, k,
tail_bound, inverse, device, stream). It is built with the same nvcc flags.
At the flagship sampling shape (N = 131072, D = 7, K = 16, the flow's
derivative bias) the script checks that both give the same bits, then
times, in the order A B B A, each way of computing the spline of raw + bias:
"earlier" = PyTorch's add of the bias, then the earlier kernel;
"fused" = this kernel with the bias. Each kernel alone is timed beside them.
Prints one line per time, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from posteriflow_torch.models.flow import _DERIV_BIAS
from posteriflow_torch.ops import rqs_cuda

N, D, K, TAIL = 131072, 7, 16, 5.0


def build_earlier(source: Path):
    """Build OLD.cu into the kernel build directory and bind its launcher."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = rqs_cuda.BUILD_DIR / f"librqs_earlier_{tag}.so"
    if not so.exists():
        rqs_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [rqs_cuda.find_nvcc(), *rqs_cuda.NVCC_FLAGS, "-o", str(so),
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    fn = ctypes.CDLL(str(so)).pf_rqs_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=Path, help="the earlier rqs.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rqs_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    earlier = build_earlier(args.earlier)
    rqs_cuda.KERNEL.load()

    rng = np.random.default_rng(0)
    r = 3 * K - 1
    dev = torch.device("cuda")
    x = torch.from_numpy(np.clip(rng.standard_normal((N, D)) * 2.5, -6, 6)
                         .astype(np.float32)).to(dev)
    raw = torch.from_numpy((rng.standard_normal((N, D * r)) * 0.7)
                           .astype(np.float32)).to(dev)
    bias = torch.zeros(r, device=dev)
    bias[2 * K:] = _DERIV_BIAS
    stream = torch.cuda.current_stream().cuda_stream

    def run_earlier(raw_in, inverse):
        out = torch.empty_like(x)
        ld = torch.empty(N, device=dev)
        err = earlier(x.data_ptr(), raw_in.data_ptr(), out.data_ptr(),
                      ld.data_ptr(), N, D, K, TAIL, int(inverse), 0, stream)
        if err != 0:
            raise RuntimeError(f"earlier kernel: CUDA error {err}")
        return out, ld

    def add_bias():
        return (raw.view(N, D, r) + bias).view(N, -1)

    def earlier_path(inverse):
        return run_earlier(add_bias(), inverse)

    def fused(inverse):
        return rqs_cuda.KERNEL.launch(x, raw, K, TAIL, inverse, bias=bias)

    for inverse in (True, False):
        (eo, el), (fo, fl) = earlier_path(inverse), fused(inverse)
        torch.cuda.synchronize()
        d_out = float((eo - fo).abs().max())
        d_ld = float((el - fl).abs().max())
        print(f"rqs_ab: {'inverse' if inverse else 'forward'} earlier vs "
              f"fused: max|Δout| {d_out:.3e}, max|Δlogdet| {d_ld:.3e}")
        if d_out != 0.0 or d_ld != 0.0:
            print("rqs_ab: the two kernels disagree", file=sys.stderr)
            return 1

    raw_biased = add_bias()
    for inverse in (True, False):
        name = "inverse" if inverse else "forward"
        turns = {"earlier": [], "fused": []}
        for label in ("earlier", "fused", "fused", "earlier"):
            fn = earlier_path if label == "earlier" else fused
            turns[label].append(time_ms(lambda: fn(inverse)))
        alone = {
            "earlier kernel alone": time_ms(
                lambda: run_earlier(raw_biased, inverse)),
            "kernel without bias": time_ms(lambda: rqs_cuda.KERNEL.launch(
                x, raw, K, TAIL, inverse)),
            "bias add alone": time_ms(add_bias),
        }
        for label, ts in turns.items():
            print(f"rqs_ab: {name} {label} [{card}]: "
                  f"{' '.join(f'{t * 1e3:.2f}' for t in ts)} us a call "
                  f"(A B B A turns)")
        for label, t in alone.items():
            print(f"rqs_ab: {name} {label} [{card}]: {t * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
