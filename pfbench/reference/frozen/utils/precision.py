"""float32 convolutions and matmuls without TF32, for the span of a block.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), and a caller may set
`torch.set_float32_matmul_precision("high")` for cuBLAS. The JAX package
computes these products in float32, so the port's float32 convs and
matmuls run inside `fp32_exact()`, which turns both off and restores the
caller's settings on exit. The library never changes them for good.
"""

from __future__ import annotations

import contextlib

import torch


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
