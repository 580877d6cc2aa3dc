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
only through `KERNEL.launches`. The library is built at first use by
utils/native.py.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from posteriflow_torch.utils import native
from posteriflow_torch.utils.precision import gelu, gelu_constants

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "conditioner.cu"
# no -fmad=false: the kernel's own products and sums are __fmul_rn /
# __fadd_rn, never contracted, and tanhf compiles as PyTorch's bf16 tanh
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
              "-Xcompiler", "-fPIC")
# csrc/conditioner.cu: kThreads; a thread takes 8 columns, so H is a
# multiple of 8 and at most 8·THREADS
THREADS = 256
MAX_HIDDEN = 8 * THREADS
# persistent blocks an SM: on an H100 at 131,072 x 256 the fastest of 4, 8
# and 16 for both passes (by 3-15 %)
BLOCKS_PER_SM = 4


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


class ConditionerKernel(native.Library):
    """The library of csrc/conditioner.cu, its launcher and launch count.

    `launches` goes up by one for each launch of the kernel and nowhere
    else; callers read and reset it to show that a path ran the kernel."""

    def __init__(self):
        super().__init__(SOURCE, NVCC_FLAGS, "conditioner")
        self._fn = None
        self.launches = 0

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
        if self._fn is None:
            self._fn = self.bind(
                "pf_cond_gelu_launch", [ctypes.c_void_p] * 4 + [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p])
        c1, c2 = gelu_constants(torch.bfloat16)
        device = p.device.index or 0
        grid = max(1, min(-(-rows // (THREADS // (h // 8))),   # persistent
                          BLOCKS_PER_SM * native.sm_count(device)))
        err = self._fn(
            p.data_ptr(), bias.data_ptr(),
            None if context is None else context.data_ptr(), out.data_ptr(),
            rows, h, rep, int(out_dtype == torch.float32), c1, c2, grid,
            device, torch.cuda.current_stream(device).cuda_stream)
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
