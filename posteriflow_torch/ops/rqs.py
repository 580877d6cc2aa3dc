"""Rational-quadratic-spline bijection (Durkan et al. NSF), plain PyTorch.

Port of posteriflow_tpu/ops/rqs.py:27-164, the path every released model
was trained through (posteriflow_tpu/models/flow.py:96, use_pallas=False).
It is the oracle for the CUDA kernel in csrc/rqs.cu and the version that
runs on CPU tensors.

Identity tails outside [-tail_bound, tail_bound] (logdet 0 there).
Shapes: inputs [..., D]; raw spline parameters [..., D, 3K-1] (K widths,
K heights, K-1 interior derivatives). Returns (out [..., D], logdet [...])
with the logdet summed over D left to right, as the CUDA kernel sums it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _sum_in_order(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    s = t[..., 0]
    for k in range(1, t.shape[-1]):
        s = s + t[..., k]
    return s


def _bin_sizes(raw: torch.Tensor, min_bin: float) -> torch.Tensor:
    """softmax over the last axis with a `min_bin` floor."""
    k = raw.shape[-1]
    e = torch.exp(raw - torch.amax(raw, dim=-1, keepdim=True))
    return min_bin + (1.0 - min_bin * k) * (e / _sum_in_order(e)[..., None])


def _knots(sizes: torch.Tensor, tail_bound: float) -> torch.Tensor:
    """[..., K] bin sizes -> [..., K+1] knots: -B, cumsum·2B - B, ..., B
    (the end knot pinned despite cumsum rounding)."""
    two_b = 2.0 * tail_bound
    edge = torch.full_like(sizes[..., 0], tail_bound)
    cols, cs = [-edge], torch.zeros_like(edge)
    for k in range(sizes.shape[-1] - 1):
        cs = cs + sizes[..., k]
        cols.append(cs * two_b - tail_bound)
    cols.append(edge)
    return torch.stack(cols, dim=-1)


def _normalize_params(raw: torch.Tensor, num_bins: int, tail_bound: float):
    """raw [..., 3K-1] -> (x_knots, y_knots, deriv), each [..., K+1] on
    [-B, B], with the boundary derivatives pinned to 1 (linear tails).

    The softmax sum and the knot cumsum run left to right, one operation
    at a time, in the order the CUDA kernel (csrc/rqs.cu) takes them: a
    knot that moves by one rounding step moves an inverse output by that
    step over the bin's slope, so the two versions must form the knots the
    same way to agree at the kernel's tolerance."""
    k = num_bins
    x_knots = _knots(_bin_sizes(raw[..., :k], DEFAULT_MIN_BIN_WIDTH),
                     tail_bound)
    y_knots = _knots(_bin_sizes(raw[..., k:2 * k], DEFAULT_MIN_BIN_HEIGHT),
                     tail_bound)
    d_interior = DEFAULT_MIN_DERIVATIVE + F.softplus(raw[..., 2 * k:])
    ones = torch.ones_like(d_interior[..., :1])
    deriv = torch.cat([ones, d_interior, ones], dim=-1)
    return x_knots, y_knots, deriv


def _searchsorted(knots: torch.Tensor, x: torch.Tensor,
                  num_bins: int) -> torch.Tensor:
    """Bin index of x in its own knot row: the count of interior knots
    <= x, in [0, K-1]."""
    idx = torch.sum(x[..., None] >= knots[..., 1:-1], dim=-1)
    return torch.clamp(idx, 0, num_bins - 1)


def _gather_bin(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [..., K+1], idx [...] -> a[..., idx] elementwise."""
    return torch.gather(a, -1, idx[..., None]).squeeze(-1)


def _bins(knots_search, xk, yk, dk, xs, num_bins):
    idx = _searchsorted(knots_search, xs, num_bins)
    return (_gather_bin(xk, idx), _gather_bin(xk, idx + 1),
            _gather_bin(yk, idx), _gather_bin(yk, idx + 1),
            _gather_bin(dk, idx), _gather_bin(dk, idx + 1))


def rqs_forward(x: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0):
    """y = f(x), log|f'(x)| summed over the last axis."""
    xk, yk, dk = _normalize_params(raw_params, num_bins, tail_bound)
    inside = torch.abs(x) <= tail_bound
    xs = torch.clamp(x, -tail_bound, tail_bound)
    x_lo, x_hi, y_lo, y_hi, d_lo, d_hi = _bins(xk, xk, yk, dk, xs, num_bins)

    w = x_hi - x_lo
    h = y_hi - y_lo
    s = h / w                                       # bin slope
    theta = torch.clamp((xs - x_lo) / w, 0.0, 1.0)
    t1m = 1.0 - theta
    tt = theta * t1m

    denom = s + (d_hi + d_lo - 2.0 * s) * tt
    y_in = y_lo + h * (s * theta ** 2 + d_lo * tt) / denom
    dydx = (s ** 2 * (d_hi * theta ** 2 + 2.0 * s * tt + d_lo * t1m ** 2)
            / denom ** 2)

    y = torch.where(inside, y_in, x)
    ld = torch.where(inside, torch.log(torch.clamp(dydx, min=1e-30)),
                     torch.zeros_like(dydx))
    return y, _sum_in_order(ld)


def rqs_inverse(y: torch.Tensor, raw_params: torch.Tensor, num_bins: int,
                tail_bound: float = 5.0):
    """x = f⁻¹(y), log|df⁻¹/dy|: one analytic quadratic solve per element
    with the numerically stable root. Same shapes as rqs_forward."""
    xk, yk, dk = _normalize_params(raw_params, num_bins, tail_bound)
    inside = torch.abs(y) <= tail_bound
    ys = torch.clamp(y, -tail_bound, tail_bound)
    x_lo, x_hi, y_lo, y_hi, d_lo, d_hi = _bins(yk, xk, yk, dk, ys, num_bins)

    w = x_hi - x_lo
    h = y_hi - y_lo
    s = h / w
    dy = ys - y_lo
    dsum = d_hi + d_lo - 2.0 * s

    # a·θ² + b·θ + c = 0 for θ ∈ [0, 1]; stable root θ = 2c / (−b − √disc)
    a = h * (s - d_lo) + dy * dsum
    b = h * d_lo - dy * dsum
    c = -s * dy
    disc = torch.clamp(b ** 2 - 4.0 * a * c, min=0.0)
    theta = 2.0 * c / (-b - torch.sqrt(disc) - 1e-30)
    theta = torch.clamp(theta, 0.0, 1.0)

    x_in = x_lo + theta * w
    t1m = 1.0 - theta
    tt = theta * t1m
    denom = s + dsum * tt
    dydx = (s ** 2 * (d_hi * theta ** 2 + 2.0 * s * tt + d_lo * t1m ** 2)
            / denom ** 2)

    x = torch.where(inside, x_in, y)
    ld = torch.where(inside, -torch.log(torch.clamp(dydx, min=1e-30)),
                     torch.zeros_like(dydx))
    return x, _sum_in_order(ld)


def rqs_forward_vjp(x: torch.Tensor, raw_params: torch.Tensor,
                    g_out: torch.Tensor, g_logdet: torch.Tensor,
                    num_bins: int, tail_bound: float = 5.0,
                    bias: torch.Tensor | None = None):
    """The vector-Jacobian product of rqs_forward on raw_params + bias:
    (g_x [..., D], g_raw [..., D, 3K-1]) for the upstream gradients g_out
    [..., D] and g_logdet [...], by autograd through the plain version.
    `bias` is a constant and gets no gradient. The oracle of the CUDA
    backward kernel (csrc/rqs.cu rqs_grad)."""
    with torch.enable_grad():
        x_ = x.detach().requires_grad_(True)
        raw_ = raw_params.detach().requires_grad_(True)
        u = raw_ if bias is None else raw_ + bias.detach()
        out, logdet = rqs_forward(x_, u, num_bins, tail_bound)
        g_x, g_raw = torch.autograd.grad((out, logdet), (x_, raw_),
                                         (g_out, g_logdet))
    return g_x, g_raw
