"""Time the RQS kernel of csrc/rqs.cu against an earlier build of the same
kernel, in turns, on one CUDA card.

    python -m posteriflow_torch.tools.rqs_ab OLD.cu
    python -m posteriflow_torch.tools.rqs_ab --backward OLD/ops/rqs_cuda.py

OLD.cu is a copy of csrc/rqs.cu from before the derivative bias moved into
the kernel: its C launcher is pf_rqs_launch(x, raw, out, logdet, n, d, k,
tail_bound, inverse, device, stream). It is built with the same nvcc flags.
At the flagship sampling shape (N = 131072, D = 7, K = 16, the flow's
derivative bias) the script checks that both give the same bits, then
times, in the order A B B A, each way of computing the spline of raw + bias:
"earlier" = PyTorch's add of the bias, then the earlier kernel;
"fused" = this kernel with the bias. Each kernel alone is timed beside them.

With --backward, the argument is an earlier checkout's
posteriflow_torch/ops/rqs_cuda.py, loaded as a module of its own, whose
kernels build from that checkout's csrc/rqs.cu. At 640 rows (the training
shape) and 131072 rows (D = 7, K = 16, the flow's derivative bias) both
backward kernels are held to the plain VJP (1e-5 of its largest entry
plus 1e-6), then timed in the order A B B A: the device time of a launch
by the profiler, and the host time a call (the host clock over 200 calls
with no synchronisation between them) of each side's GRAD_KERNEL.launch
and RqsForwardFn.backward, the entry the backward of a train step takes,
over HOST_PAIRS pairs in alternating order.
Prints one line per time, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from posteriflow_torch.models.flow import _DERIV_BIAS
from posteriflow_torch.ops import rqs as plain
from posteriflow_torch.ops import rqs_cuda

N, D, K, TAIL = 131072, 7, 16, 5.0
HOST_PAIRS = 10


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


def device_ms(fn, reps: int = 20):
    """Device time of one launch of the backward kernel that fn() launches,
    by torch.profiler over `reps` calls (None without CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError:
        return None
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and "rqs_grad" in e.key]
    count = sum(e.count for e in evs)
    return (sum(e.self_device_time_total for e in evs) / count / 1e3
            if count else None)


def host_us(fn, reps: int = 200) -> float:
    """Host µs of one fn() call: the host clock over `reps` calls with no
    synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def load_earlier_wrapper(path: Path):
    """An earlier checkout's ops/rqs_cuda.py as a module of its own: its
    kernels build from that checkout's csrc/rqs.cu into its _build/."""
    spec = importlib.util.spec_from_file_location("rqs_cuda_earlier", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module       # its dataclasses look it up
    spec.loader.exec_module(module)
    return module


def backward_ab(earlier, card: str) -> int:
    """The two backward kernels held to the plain VJP, then timed in
    turns at the training shape and at 131072 rows: device time, and the
    host time of GRAD_KERNEL.launch and of RqsForwardFn.backward."""
    r = 3 * K - 1
    dev = torch.device("cuda")
    for n in (640, N):
        rng = np.random.default_rng(n)
        x = torch.from_numpy(np.clip(rng.standard_normal((n, D)) * 2.5, -6,
                                     6).astype(np.float32)).to(dev)
        raw = torch.from_numpy((rng.standard_normal((n, D * r)) * 0.7)
                               .astype(np.float32)).to(dev)
        g_out = torch.from_numpy(rng.standard_normal((n, D))
                                 .astype(np.float32)).to(dev)
        g_ld = torch.from_numpy(rng.standard_normal(n)
                                .astype(np.float32)).to(dev)
        bias = torch.zeros(r, device=dev)
        bias[2 * K:] = _DERIV_BIAS
        ctx = SimpleNamespace(saved_tensors=(x, raw, bias), spline=(K, TAIL))
        sides = {}
        for label, module in (("earlier", earlier), ("this", rqs_cuda)):
            sides[label] = (
                lambda m=module: m.GRAD_KERNEL.launch(x, raw, g_out, g_ld, K,
                                                      TAIL, bias),
                lambda m=module: m.RqsForwardFn.backward(ctx, g_out, g_ld))
        ref = plain.rqs_forward_vjp(x, raw.view(n, D, r), g_out, g_ld, K,
                                    TAIL, bias=bias)
        for label, (launch, _) in sides.items():
            got = launch()
            torch.cuda.synchronize()
            errs = [float((g.reshape(e.shape) - e).abs().max())
                    for g, e in zip(got, ref)]
            scale = [float(e.abs().max()) for e in ref]
            print(f"rqs_ab: backward {label} N={n} vs the plain VJP: "
                  f"max|Δ| {errs[0] / scale[0]:.2e} (g_x), "
                  f"{errs[1] / scale[1]:.2e} (g_raw) of the largest entry")
            if any(e > 1e-5 * m + 1e-6 for e, m in zip(errs, scale)):
                print("rqs_ab: a backward kernel is off the plain VJP",
                      file=sys.stderr)
                return 1
        dev_ms = {"earlier": [], "this": []}
        for label in ("earlier", "this", "this", "earlier"):
            dev_ms[label].append(device_ms(sides[label][0]))
        # the host's load moves its times by half between turns: pairs
        host = {(label, i): [] for label in sides for i in range(2)}
        with torch.no_grad():
            for pair in range(HOST_PAIRS):
                order = ("earlier", "this") if pair % 2 else ("this",
                                                              "earlier")
                for label in order:
                    for i, fn in enumerate(sides[label]):
                        host[label, i].append(host_us(fn))
        for label in sides:
            print(f"rqs_ab: backward {label} N={n} D={D} K={K} bias [{card}]: "
                  "device time a launch "
                  + " ".join("not measured" if t is None else f"{t * 1e3:.2f}"
                             for t in dev_ms[label])
                  + " us (profiler, A B B A turns); host time a call over "
                  f"{HOST_PAIRS} alternating pairs, median [quartiles]: "
                  f"GRAD_KERNEL.launch {_spread(host[label, 0])} us, "
                  f"RqsForwardFn.backward {_spread(host[label, 1])} us")
        wins = sum(a < b for a, b in zip(host["this", 1], host["earlier", 1]))
        print(f"rqs_ab: backward N={n}: RqsForwardFn.backward took less host "
              f"time than the earlier one in {wins} of {HOST_PAIRS} pairs")
        parts = host_parts(x, raw, g_out, g_ld, bias)
        print(f"rqs_ab: backward N={n} [{card}]: this host path's parts, "
              "us a call: " + ", ".join(f"{k} {host_us(f):.1f}"
                                        for k, f in parts.items()))
    return 0


def host_parts(x, raw, g_out, g_ld, bias) -> dict:
    """The pieces of this checkout's backward host path, each to be timed
    alone."""
    fn = rqs_cuda.GRAD_KERNEL._bind()
    g_x, g_raw = torch.empty_like(x), torch.empty_like(raw)
    ptrs = [t.data_ptr() for t in (x, raw, bias, g_out, g_ld, g_x, g_raw)]
    n = x.shape[0]
    return {
        "the ctypes call refused before any CUDA call (n = 0)":
            lambda: fn(*ptrs, 0, D, K, TAIL, 0, 0),
        "the ctypes call and the launch": lambda: fn(*ptrs, n, D, K, TAIL, 0,
                                                     0),
        "the two output allocations": lambda: (torch.empty_like(x),
                                               torch.empty_like(raw)),
        "the current stream's handle":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "the upstream checks": lambda: rqs_cuda._check_upstream(x, g_out,
                                                                g_ld),
        "the spline checks (skipped by RqsForwardFn.backward)":
            lambda: rqs_cuda._check_spline_args(x, raw, K, bias)}


def _spread(values) -> str:
    q = np.percentile(values, [50, 25, 75])
    return f"{q[0]:.1f} [{q[1]:.1f}, {q[2]:.1f}]"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=Path,
                    help="the earlier rqs.cu (with --backward: the earlier "
                         "ops/rqs_cuda.py)")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward kernels rqs_grad")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rqs_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rqs_cuda.KERNEL.load()
    if args.backward:
        return backward_ab(load_earlier_wrapper(args.earlier), card)
    earlier = build_earlier(args.earlier)

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
