"""The tail of a flow conditioner's hidden layer (csrc/conditioner.cu): the
bias add, the context add and flax's tanh GELU over a bf16 product, in one
pass that gives the eager ops' bits.

`bias_gelu(p, bias, context, out_dtype)` is gelu(p + bias [+ context]) in
p's dtype, op by op as the JAX package rounds, then cast to `out_dtype`.
It chooses by what its inputs show: the kernel for CUDA tensors in
bfloat16 that need no gradient (grad mode off, or none of them requires
grad), the plain version (`bias_gelu_plain`, the op sequence) otherwise:
CPU tensors, other dtypes, and autograd, for which the kernel has no
backward. On a CUDA tensor it takes, the kernel launches or raises; there
is no fallback. The two give the same bits, so a caller sees which ran
only through `KERNEL.launches`.

The library is built at first use as ops/rqs_cuda.py builds its own
(nvcc, a plain C interface, ctypes; cached by a hash of source and flags
in ``posteriflow_torch/_build/``), with NVCC_FLAGS below: no -fmad=false,
since the kernel's own products and sums are __fmul_rn / __fadd_rn, which
are never contracted, and tanhf is then compiled as PyTorch's bf16 tanh
compiles it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from posteriflow_torch.ops.rqs_cuda import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "conditioner.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
              "-Xcompiler", "-fPIC")
# csrc/conditioner.cu: kThreads; a thread takes 8 columns, so H is a
# multiple of 8 and at most 8·THREADS
THREADS = 256
MAX_HIDDEN = 8 * THREADS
# persistent blocks an SM: on an H100 at 131,072 x 256 the fastest of 4, 8
# and 16 for both passes (by 3-15 %)
BLOCKS_PER_SM = 4


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant `c` rounded to `dtype`, as JAX casts a Python scalar to
    the array's dtype before an operation."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


@functools.lru_cache(maxsize=None)
def gelu_constants(dtype: torch.dtype):
    """(c1, c2) of the tanh GELU, rounded to `dtype` (kept per dtype: the
    rounding costs ~10 µs of host time a call)."""
    return (in_dtype(math.sqrt(2.0 / math.pi), dtype),
            in_dtype(0.044715, dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax nn.gelu, the tanh approximation, written out as jax.nn.gelu
    computes it: op by op in x's dtype, with constants rounded to that
    dtype. In bfloat16 this rounds where JAX rounds; F.gelu rounds once and
    differs from JAX in the last bit of about 40% of bf16 outputs."""
    c1, c2 = gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x)))))


def bias_gelu_plain(p: torch.Tensor, bias: torch.Tensor,
                    context: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """gelu(p + bias [+ context]) op by op in p's dtype, then cast to
    `out_dtype` (p's dtype when None): the plain version of the kernel."""
    s = p + bias
    if context is not None:
        s = s + context
    h = gelu(s)
    return h if out_dtype is None else h.to(out_dtype)


def kernel_takes(p: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """The dispatch of `bias_gelu`: True for a CUDA bfloat16 `p` when no
    gradient is needed through p or `others`."""
    if p.device.type != "cuda" or p.dtype != torch.bfloat16:
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (p, *others)))


def context_rep(p_shape, c_shape) -> int:
    """How many consecutive rows of p [..., H] share a row of the context:
    the context's shape is p's leading dims, then ones, then H (1 for a
    context per row; n for [B, 1, H] against [B, n, H])."""
    if len(c_shape) != len(p_shape) or c_shape[-1] != p_shape[-1]:
        raise ValueError(f"context {tuple(c_shape)} does not broadcast "
                         f"row-wise over p {tuple(p_shape)}")
    k = 0
    while k < len(p_shape) - 1 and c_shape[k] == p_shape[k]:
        k += 1
    if any(c != 1 for c in c_shape[k:-1]):
        raise ValueError(f"context {tuple(c_shape)} does not broadcast "
                         f"row-wise over p {tuple(p_shape)}")
    return math.prod(p_shape[k:-1])


class ConditionerKernel:
    """The loaded library and its launch count.

    `launches` goes up by one for each launch of the kernel and nowhere
    else; callers read and reset it to show that a path ran the kernel."""

    def __init__(self):
        self._fn = None
        self._sm_count = {}
        self.launches = 0
        self.build_seconds: Optional[float] = None   # None: library cached
        self.build_log = ""

    def load(self):
        """Build (if the cached library is missing) and bind the launcher."""
        if self._fn is not None:
            return self._fn
        so, self.build_seconds, self.build_log = build_library(
            SOURCE, NVCC_FLAGS, "conditioner")
        fn = ctypes.CDLL(str(so)).pf_cond_gelu_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def grid(self, rows: int, h: int, device: torch.device) -> int:
        """Persistent blocks for `rows` rows of width h on `device`."""
        idx = device.index if device.index is not None else 0
        if idx not in self._sm_count:
            self._sm_count[idx] = torch.cuda.get_device_properties(
                idx).multi_processor_count
        rows_per_block = THREADS // (h // 8)
        return max(1, min(-(-rows // rows_per_block),
                          BLOCKS_PER_SM * self._sm_count[idx]))

    def launch(self, p: torch.Tensor, bias: torch.Tensor,
               context: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """p [..., H] and bias [H] bfloat16 on one CUDA device, context
        bfloat16 of p's leading dims then ones then H, or None ->
        gelu(p + bias [+ context]) with every op rounded to bfloat16, as
        bfloat16 or float32 (`out_dtype`), on PyTorch's current stream."""
        out_dtype = p.dtype if out_dtype is None else out_dtype
        tensors = {"p": p, "bias": bias}
        if context is not None:
            tensors["context"] = context
        for name, t in tensors.items():
            if t.dtype != torch.bfloat16:
                raise TypeError(f"conditioner kernel takes bfloat16, got "
                                f"{name} in {t.dtype}")
        if out_dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"conditioner kernel writes bfloat16 or float32, "
                            f"not {out_dtype}")
        h = p.shape[-1]
        if h % 8 != 0 or not 0 < h <= MAX_HIDDEN:
            raise ValueError(f"conditioner kernel needs a width H that is a "
                             f"multiple of 8 up to {MAX_HIDDEN}, got H={h}")
        if tuple(bias.shape) != (h,):
            raise ValueError(f"bias must be [{h}], got {tuple(bias.shape)}")
        rep = 1 if context is None else context_rep(p.shape, context.shape)
        for name, t in tensors.items():
            if t.device.type != "cuda" or t.device != p.device:
                raise ValueError(f"conditioner kernel needs p, bias and the "
                                 f"context on one CUDA device, got {name} on "
                                 f"{t.device}")
        rows = p.numel() // h
        if rows >= 2 ** 31 - 2 ** 20:
            raise ValueError(f"too many rows for the kernel: {rows}")
        tensors = {k: t.contiguous() for k, t in tensors.items()}
        for name, t in tensors.items():
            if t.data_ptr() % 16 != 0:
                raise ValueError(f"conditioner kernel needs {name} at a "
                                 f"16-byte aligned address")
        p, bias, context = (tensors["p"], tensors["bias"],
                            tensors.get("context"))
        out = torch.empty(p.shape, dtype=out_dtype, device=p.device)
        if rows == 0:
            return out
        c1, c2 = gelu_constants(torch.bfloat16)
        dev = p.device
        err = self.load()(
            p.data_ptr(), bias.data_ptr(),
            None if context is None else context.data_ptr(), out.data_ptr(),
            rows, h, rep, int(out_dtype == torch.float32), c1, c2,
            self.grid(rows, h, dev), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"conditioner kernel launch failed with CUDA "
                               f"error {err}")
        self.launches += 1
        return out


KERNEL = ConditionerKernel()


def bias_gelu(p: torch.Tensor, bias: torch.Tensor,
              context: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """gelu(p + bias [+ context]) in p's dtype, cast to `out_dtype`: the
    kernel where `kernel_takes` says so, else the plain version."""
    if kernel_takes(p, bias, context):
        return KERNEL.launch(p, bias, context, out_dtype)
    return bias_gelu_plain(p, bias, context, out_dtype)
