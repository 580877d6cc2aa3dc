"""The port's precision contract: float32 without TF32, and a lower
compute dtype rounded where JAX rounds.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), and a caller may set
`torch.set_float32_matmul_precision("high")` for cuBLAS. The JAX package
computes these products in float32, so the port's float32 convs and
matmuls run inside `fp32_exact()`, which turns both off and restores the
caller's settings on exit. The library never changes them for good.
`dense`, `gelu` and `in_dtype` round op by op, with constants cast to the
array's dtype first, as JAX does in bf16.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

# float64 is a reference precision for checks (a model moved there with
# .double() runs on the CPU, where the spline is the plain version)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


@contextlib.contextmanager
def fp32_exact():
    conv_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
        torch.set_float32_matmul_precision(matmul)


def in_dtype(c: float, dtype: torch.dtype) -> float:
    """The constant `c` rounded to `dtype`, as JAX casts a Python scalar to
    the array's dtype before an operation."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """flax Dense(dtype=...): input, kernel and bias cast to `dtype`, the
    product rounded to `dtype`, then the bias added in `dtype`."""
    return (F.linear(x.to(dtype), layer.weight.to(dtype))
            + layer.bias.to(dtype))


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
