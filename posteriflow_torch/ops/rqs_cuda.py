"""The RQS kernel of csrc/rqs.cu: build with nvcc, bind with ctypes, launch.

`rqs_forward` / `rqs_inverse` take the signature of ops/rqs.py and choose
by the tensor's device: a CPU tensor goes through the plain PyTorch
version, a CUDA tensor through the kernel (or an exception; there is no
fallback). The kernel replaces the TPU kernel
posteriflow_tpu/ops/pallas_rqs.py:_pallas_rqs; csrc/rqs.cu says what bounds
it and how it is laid out.

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
import shutil
import subprocess
import time
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
SUPPORTED_BINS = (4, 8, 16, 32)      # template instances in csrc/rqs.cu
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


class RqsKernel:
    """The loaded library and its launch count.

    `launches` goes up by one for each launch of the kernel and nowhere
    else; callers read and reset it to show that a path ran the kernel."""

    def __init__(self):
        self._fn = None
        self.launches = 0
        self.build_seconds: Optional[float] = None   # None: library cached
        self.build_log = ""

    def load(self):
        """Build (if the cached library is missing) and bind the launcher."""
        if self._fn is not None:
            return self._fn
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(build_command(find_nvcc(), tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:"
                                   f"\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = proc.stdout + proc.stderr
        fn = ctypes.CDLL(str(so)).pf_rqs_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, x: torch.Tensor, raw: torch.Tensor, num_bins: int,
               tail_bound: float, inverse: bool):
        """x [N, D], raw [N, D·(3K-1)]: contiguous float32 on one CUDA
        device -> (out [N, D], logdet [N]) on PyTorch's current stream."""
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
        if tuple(raw.shape) != (n, d * (3 * num_bins - 1)):
            raise ValueError(f"raw must be [{n}, {d * (3 * num_bins - 1)}], "
                             f"got {tuple(raw.shape)}")
        if not (x.is_contiguous() and raw.is_contiguous()):
            raise ValueError("rqs kernel needs contiguous x and raw")
        if n >= 2 ** 31:
            raise ValueError(f"too many rows for the kernel: {n}")
        out = torch.empty_like(x)
        logdet = torch.empty(n, dtype=torch.float32, device=x.device)
        if n == 0:
            return out, logdet
        fn = self.load()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), raw.data_ptr(), out.data_ptr(),
                 logdet.data_ptr(), n, d, num_bins, float(tail_bound),
                 int(bool(inverse)), x.device.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"rqs kernel launch failed with CUDA error "
                               f"{err}")
        self.launches += 1
        return out, logdet


KERNEL = RqsKernel()


def _rqs(x: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
         tail_bound: float, inverse: bool):
    if x.device.type == "cpu":
        fn = plain.rqs_inverse if inverse else plain.rqs_forward
        return fn(x, raw_params, num_bins, tail_bound)
    if x.device.type != "cuda":
        raise ValueError(f"no RQS implementation for device {x.device}")
    batch, d = x.shape[:-1], x.shape[-1]
    n_raw = 3 * num_bins - 1
    if tuple(raw_params.shape) != (*batch, d, n_raw):
        raise ValueError(f"raw_params must be {(*batch, d, n_raw)}, got "
                         f"{tuple(raw_params.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    raw2 = raw_params.reshape(x2.shape[0], d * n_raw).contiguous()
    out, logdet = KERNEL.launch(x2, raw2, num_bins, tail_bound, inverse)
    return out.reshape(*batch, d), logdet.reshape(batch)


def rqs_forward(x: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0):
    """Drop-in for ops.rqs.rqs_forward: the kernel on CUDA tensors."""
    return _rqs(x, raw_params, num_bins, tail_bound, inverse=False)


def rqs_inverse(y: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0):
    """Drop-in for ops.rqs.rqs_inverse: the kernel on CUDA tensors."""
    return _rqs(y, raw_params, num_bins, tail_bound, inverse=True)
