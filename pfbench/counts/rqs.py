"""Bytes the rational-quadratic spline kernels must move, each input read
once and each output written once (float32), as chip_smoke.py counts them:
at [131072, 7], K = 16 the forward moves 180 MB."""

from __future__ import annotations


def rqs_bytes(n: int, d: int, k: int, bias: bool = True) -> int:
    """rqs_tile (forward or inverse) over n rows of d splines with k bins:
    x [n, d] and raw [n, d·(3k-1)] read, the bias [3k-1] read where the
    kernel adds it, y [n, d] and logdet [n] written."""
    r = 3 * k - 1
    return 4 * (n * d + n * d * r + (r if bias else 0) + n * d + n)


def rqs_grad_bytes(n: int, d: int, k: int, bias: bool = True) -> int:
    """rqs_grad: x, raw, the bias, g_out [n, d] and g_logdet [n] read,
    g_x [n, d] and g_raw [n, d·(3k-1)] written."""
    r = 3 * k - 1
    return 4 * (n * d + n * d * r + (r if bias else 0) + n * d + n
                + n * d + n * d * r)
