"""The RQS kernels of csrc/rqs.cu: build with nvcc, bind with ctypes, launch.

`rqs_forward` / `rqs_inverse` take the signature of ops/rqs.py plus an
optional `bias` [3K-1] added to the raw parameters, and choose by the
tensor's device: a CPU tensor goes through the plain PyTorch version on
raw + bias, a CUDA tensor through the kernel, which adds the bias as it
reads raw (or an exception; there is no fallback). The forward direction is
differentiable on the card: under grad it runs as `RqsForwardFn`, whose
backward is the kernel `rqs_grad` (d/dx and d/draw; the bias is a constant
and may not require grad). The inverse has no backward, as in the JAX
package: on CUDA inputs that require grad, with grad enabled, it raises
rather than return outputs that autograd cannot see through. The forward
and inverse kernel replaces the TPU kernel
posteriflow_tpu/ops/pallas_rqs.py:_pallas_rqs; csrc/rqs.cu says what bounds
each kernel and how it is laid out, and `tile_plan` below sizes the
forward's ring of row tiles.

The shared library is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-fmad=false``
into ``posteriflow_torch/_build/`` (git-ignored), named by a hash of the
source and flags, and loaded with ctypes. It has a plain C interface and
includes no PyTorch header, so the build takes seconds and needs neither
ninja nor pybind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from posteriflow_torch.ops import rqs as plain

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "rqs.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no fused multiply-add, so that each product and sum rounds as
# it does in the plain version (see csrc/rqs.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-fmad=false")
SUPPORTED_BINS = (4, 8, 12, 16, 32)  # template instances in csrc/rqs.cu
# csrc/rqs.cu: kThreads, kStages, kBarrierBytes, __launch_bounds__(256, 2)
THREADS = 256
STAGES = 2
BARRIER_BYTES = 128
BLOCKS_PER_SM = 2
# Hopper: the shared memory an SM divides among its blocks, what the runtime
# keeps of it for each block, and the most one block may take
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
SMEM_PER_BLOCK = 232448
# the toolkit's standard install prefix, tried after CUDA_HOME and PATH
_DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc(default_home: str = _DEFAULT_CUDA_HOME) -> str:
    """Path of nvcc from $CUDA_HOME, then $PATH, then the toolkit's
    standard prefix. Raises RuntimeError if none has it."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(default_home) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit or "
                       "put nvcc on PATH")


def build_command(nvcc: str, output: Path) -> list:
    """The nvcc command line that builds the kernel library."""
    return [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(output),
            str(SOURCE)]


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librqs_{tag}.so"


def stage_bytes(rows: int, d: int, k: int) -> int:
    """One stage of the ring: a tile's raw [rows, D·(3K-1)] and its x
    [rows, D], float32."""
    return 4 * rows * d * 3 * k


def smem_bytes(rows: int, d: int, k: int) -> int:
    """Dynamic shared memory of one block (csrc/rqs.cu smem_layout_bytes):
    the mbarriers, STAGES stages, a logdet per spline for two tiles and the
    bias."""
    return (BARRIER_BYTES + STAGES * stage_bytes(rows, d, k)
            + 2 * 4 * rows * d + 4 * (3 * k - 1))


@dataclass(frozen=True)
class TilePlan:
    """How one launch cuts N rows into tiles and blocks."""
    rows_per_tile: int      # TR, a multiple of 4: a tile is 16-B aligned
    full_tiles: int         # tiles the TMA bulk copy brings in
    tail_rows: int          # N mod TR rows of the ragged last tile
    stage_bytes: int        # one tile of raw and x, TR·D·3K floats
    smem_bytes: int         # dynamic shared memory of a block
    grid: int               # persistent blocks


def tile_plan(n: int, d: int, k: int, sm_count: int) -> TilePlan:
    """The launch's tile plan: as many rows a tile as give one spline a
    thread (THREADS // D, down to a multiple of 4; at least 4, and then a
    thread takes several), fewer where BLOCKS_PER_SM blocks of STAGES tiles
    would not fit an SM's shared memory; one persistent block per tile up
    to BLOCKS_PER_SM blocks an SM."""
    if n < 0 or d < 1 or k not in SUPPORTED_BINS or sm_count < 1:
        raise ValueError(f"no tile plan for n={n}, d={d}, k={k}, "
                         f"sm_count={sm_count}")
    rows = max(4, THREADS // d // 4 * 4)
    budget = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED
    while rows > 4 and smem_bytes(rows, d, k) > budget:
        rows -= 4
    smem = smem_bytes(rows, d, k)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a tile of 4 rows at d={d}, k={k} needs {smem} B "
                         f"of shared memory, more than {SMEM_PER_BLOCK}")
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    n_tiles = -(-n // rows)
    return TilePlan(rows_per_tile=rows, full_tiles=n // rows,
                    tail_rows=n % rows, stage_bytes=stage_bytes(rows, d, k),
                    smem_bytes=smem,
                    grid=max(1, min(n_tiles, per_sm * sm_count)))


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_INSTANCE = re.compile(r"rqs_tileILi(\d+)ELb([01])ELb([01])E")
_GRAD_INSTANCE = re.compile(r"rqs_gradILi(\d+)ELb([01])E")


def ptxas_instances(log: str, kernel: str = "rqs_tile") -> list:
    """What `-Xptxas -v` says of each instance of `kernel`:
    rqs_tile<K, INVERSE, BIAS> gives [{"k", "inverse", "bias", "registers",
    "stack", "spill_stores", "spill_loads"}, ...], rqs_grad<K, BIAS> the
    same without "inverse", in the order ptxas compiled them."""
    pattern = {"rqs_tile": _INSTANCE, "rqs_grad": _GRAD_INSTANCE}[kernel]
    found, cur = [], None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            inst = pattern.search(m.group(1))
            cur = None
            if inst:
                cur = {"k": int(inst.group(1)),
                       "bias": inst.group(inst.lastindex) == "1"}
                if kernel == "rqs_tile":
                    cur["inverse"] = inst.group(2) == "1"
                found.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return found


class RqsKernel:
    """The loaded library and its launch count.

    `launches` goes up by one for each launch of the kernel and nowhere
    else; callers read and reset it to show that a path ran the kernel."""

    def __init__(self):
        self._fn = None
        self._lib = None
        self._sm_count = {}
        self.launches = 0
        self.build_seconds: Optional[float] = None   # None: library cached
        self.build_log = ""

    def load(self):
        """Build (if the cached library is missing) and bind the launcher.
        The compiler's output is kept beside the library, so `build_log`
        holds it whether or not this process built it."""
        if self._fn is not None:
            return self._fn
        so = library_path()
        log = so.with_suffix(".log")
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(build_command(find_nvcc(), tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:"
                                   f"\n{proc.stdout}\n{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
            self.build_seconds = time.perf_counter() - t0
        self.build_log = log.read_text() if log.exists() else ""
        self._lib = ctypes.CDLL(str(so))
        fn = self._lib.pf_rqs_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def library(self) -> ctypes.CDLL:
        """The loaded library (built at first use)."""
        self.load()
        return self._lib

    def plan(self, n: int, d: int, k: int, device: torch.device) -> TilePlan:
        """tile_plan for the card `device` (its SM count read once)."""
        idx = device.index if device.index is not None else 0
        if idx not in self._sm_count:
            self._sm_count[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        return tile_plan(n, d, k, self._sm_count[idx])

    def launch(self, x: torch.Tensor, raw: torch.Tensor, num_bins: int,
               tail_bound: float, inverse: bool,
               bias: Optional[torch.Tensor] = None):
        """x [N, D] and raw [N, D·(3K-1)] 16-B aligned, bias [3K-1] or None:
        contiguous float32 on one CUDA device -> (out [N, D], logdet [N])
        of the spline on raw + bias, on PyTorch's current stream."""
        n, d = _check_spline_args(x, raw, num_bins, bias)
        if raw.data_ptr() % 16 != 0 or x.data_ptr() % 16 != 0:
            raise ValueError("rqs kernel needs x and raw at 16-byte aligned "
                             "addresses (its tiles are bulk copies)")
        out = torch.empty_like(x)
        logdet = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out, logdet
        fn = self.load()
        plan = self.plan(n, d, num_bins, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), raw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 logdet.data_ptr(), n, d, num_bins, float(tail_bound),
                 int(bool(inverse)), plan.rows_per_tile, plan.grid,
                 plan.smem_bytes, x.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"rqs kernel launch failed with CUDA error "
                               f"{err}")
        self.launches += 1
        return out, logdet


KERNEL = RqsKernel()


def _check_spline_args(x: torch.Tensor, raw: torch.Tensor, num_bins: int,
                       bias: Optional[torch.Tensor]):
    """The checks both launchers share: x [N, D] and raw [N, D·(3K-1)]
    contiguous float32 on one CUDA device, K built, bias a contiguous
    float32 [3K-1] there or None. Returns (N, D)."""
    if x.device.type != "cuda" or raw.device != x.device:
        raise ValueError(f"rqs kernel needs x and raw on one CUDA device, "
                         f"got {x.device} and {raw.device}")
    if x.dtype != torch.float32 or raw.dtype != torch.float32:
        raise TypeError(f"rqs kernel takes float32, got {x.dtype} and "
                        f"{raw.dtype}")
    if num_bins not in SUPPORTED_BINS:
        raise ValueError(f"rqs kernel is built for K in {SUPPORTED_BINS}, "
                         f"got {num_bins}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    n, d = x.shape
    n_raw = 3 * num_bins - 1
    if tuple(raw.shape) != (n, d * n_raw):
        raise ValueError(f"raw must be [{n}, {d * n_raw}], "
                         f"got {tuple(raw.shape)}")
    if not (x.is_contiguous() and raw.is_contiguous()):
        raise ValueError("rqs kernel needs contiguous x and raw")
    if bias is not None:
        if bias.device != x.device or bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32 on {x.device}, got "
                             f"{bias.dtype} on {bias.device}")
        if tuple(bias.shape) != (n_raw,) or not bias.is_contiguous():
            raise ValueError(f"bias must be a contiguous [{n_raw}], got "
                             f"{tuple(bias.shape)}")
    if n >= 2 ** 31 - THREADS:
        raise ValueError(f"too many rows for the kernel: {n}")
    return n, d


class RqsGradKernel:
    """The backward kernel rqs_grad<K, BIAS> of the same library, and its
    launch count (`launches`: one for each launch, nowhere else)."""

    def __init__(self, forward: RqsKernel):
        self._forward = forward
        self._fn = None
        self.launches = 0

    def _bind(self):
        if self._fn is None:
            fn = self._forward.library().pf_rqs_grad_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, x: torch.Tensor, raw: torch.Tensor,
               g_out: torch.Tensor, g_logdet: torch.Tensor, num_bins: int,
               tail_bound: float, bias: Optional[torch.Tensor] = None):
        """x [N, D], raw [N, D·(3K-1)], g_out [N, D], g_logdet [N]:
        contiguous float32 on one CUDA device, bias [3K-1] or None ->
        (g_x [N, D], g_raw [N, D·(3K-1)]) of the forward spline on
        raw + bias, on PyTorch's current stream."""
        _check_spline_args(x, raw, num_bins, bias)
        _check_upstream(x, g_out, g_logdet)
        return self._launch(x, raw, g_out, g_logdet, num_bins, tail_bound,
                            bias)

    def _launch(self, x, raw, g_out, g_logdet, num_bins, tail_bound, bias):
        """`launch` without its checks, for a caller that has made them
        (RqsForwardFn.backward: its forward checked x, raw and bias)."""
        g_x = torch.empty_like(x)
        g_raw = torch.empty_like(raw)
        if x.shape[0] == 0:
            return g_x, g_raw
        device = x.get_device()
        err = self._bind()(
            x.data_ptr(), raw.data_ptr(),
            None if bias is None else bias.data_ptr(), g_out.data_ptr(),
            g_logdet.data_ptr(), g_x.data_ptr(), g_raw.data_ptr(),
            x.shape[0], x.shape[1], num_bins, float(tail_bound), device,
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rqs grad kernel launch failed with CUDA "
                               f"error {err}")
        self.launches += 1
        return g_x, g_raw


def _check_upstream(x: torch.Tensor, g_out: torch.Tensor,
                    g_logdet: torch.Tensor):
    """The backward's upstream gradients: g_out [N, D] and g_logdet [N],
    contiguous float32 on x's device."""
    n, d = x.shape
    for name, t, shape in (("g_out", g_out, (n, d)),
                           ("g_logdet", g_logdet, (n,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{list(shape)} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


GRAD_KERNEL = RqsGradKernel(KERNEL)


class RqsForwardFn(torch.autograd.Function):
    """The forward spline kernel with the backward kernel as its gradient:
    x [N, D], raw [N, D·(3K-1)] (both 16-B aligned) and a constant bias ->
    (out [N, D], logdet [N]). Saves x and the bias-less raw. The backward
    kernel's outputs carry no graph, so its backward raises under
    create_graph rather than let a second derivative lose its terms."""

    @staticmethod
    def forward(ctx, x, raw, num_bins, tail_bound, bias):
        out, logdet = KERNEL.launch(x, raw, num_bins, tail_bound, False,
                                    bias)
        ctx.save_for_backward(x, raw, bias)
        ctx.spline = (num_bins, tail_bound)
        return out, logdet

    @staticmethod
    def backward(ctx, g_out, g_logdet):
        # grad mode is on here only under create_graph. once_differentiable
        # would not do: it raises only where g_out or g_logdet require grad,
        # and a second derivative in x reaches this node through x alone.
        if torch.is_grad_enabled():
            raise RuntimeError("the CUDA RQS backward kernel has no "
                               "derivative of its own: take the gradient "
                               "without create_graph")
        x, raw, bias = ctx.saved_tensors
        g_out = (torch.zeros_like(x) if g_out is None
                 else g_out.float().contiguous())
        g_logdet = (x.new_zeros(x.shape[0]) if g_logdet is None
                    else g_logdet.float().contiguous())
        # forward checked x, raw and bias (saved unchanged: autograd checks
        # their versions); the upstream gradients are new here
        _check_upstream(x, g_out, g_logdet)
        g_x, g_raw = GRAD_KERNEL._launch(x, raw, g_out, g_logdet,
                                         *ctx.spline, bias)
        return g_x, g_raw, None, None, None


def _rqs(x: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
         tail_bound: float, inverse: bool, bias: Optional[torch.Tensor]):
    if x.device.type == "cpu":
        fn = plain.rqs_inverse if inverse else plain.rqs_forward
        if bias is not None:
            raw_params = raw_params + bias
        return fn(x, raw_params, num_bins, tail_bound)
    if x.device.type != "cuda":
        raise ValueError(f"no RQS implementation for device {x.device}")
    differentiate = torch.is_grad_enabled() and (
        x.requires_grad or raw_params.requires_grad)
    if torch.is_grad_enabled() and (
            (inverse and differentiate)
            or (bias is not None and bias.requires_grad)):
        # the kernel writes its outputs through raw pointers, so autograd
        # would see no graph and a loss would lose these gradients silently
        raise RuntimeError("the CUDA RQS kernel has no backward for the "
                           + ("inverse" if inverse else "derivative bias, a "
                              "constant")
                           + ": call it under torch.no_grad(), or on inputs "
                             "that do not require grad")
    batch, d = x.shape[:-1], x.shape[-1]
    n_raw = 3 * num_bins - 1
    if tuple(raw_params.shape) != (*batch, d, n_raw):
        raise ValueError(f"raw_params must be {(*batch, d, n_raw)}, got "
                         f"{tuple(raw_params.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    if x2.data_ptr() % 16 != 0:          # a view into x: copy its N·D floats
        x2 = x2.clone()
    raw2 = raw_params.reshape(x2.shape[0], d * n_raw).contiguous()
    if differentiate:
        out, logdet = RqsForwardFn.apply(x2, raw2, num_bins, tail_bound,
                                         bias)
    else:
        out, logdet = KERNEL.launch(x2, raw2, num_bins, tail_bound, inverse,
                                    bias)
    return out.reshape(*batch, d), logdet.reshape(batch)


def rqs_forward(x: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0,
                bias: Optional[torch.Tensor] = None):
    """ops.rqs.rqs_forward on raw_params + bias: the kernel on CUDA
    tensors, differentiable in x and raw_params."""
    return _rqs(x, raw_params, num_bins, tail_bound, False, bias)


def rqs_inverse(y: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0,
                bias: Optional[torch.Tensor] = None):
    """ops.rqs.rqs_inverse on raw_params + bias: the kernel on CUDA
    tensors (no backward)."""
    return _rqs(y, raw_params, num_bins, tail_bound, True, bias)
