"""The spline's CUDA backward kernel (csrc/rqs.cu rqs_grad, a group of G
lanes a spline: K rounded up to a power of two, K = 12 in 16) as its lanes
run it, emulated in float32 on the CPU, against the
plain VJP (ops/rqs.py rqs_forward_vjp); and the backward entry of
RqsForwardFn, which skips the checks its forward made on x, raw and bias
but still checks the upstream gradients.

The emulation keeps the kernel's order: each lane's own exp and division,
the softmax sum and the knot cumsum left to right over the gathered
lanes, the bin as the count of interior knots <= x (the ballot), the
bin's ends and derivatives from lanes idx-1 and idx, the map's reverse in
the kernel's log-derivative form, the per-lane gradient on each softmax
entry, the softmax Jacobian's dot product as the kernel's butterfly over
the group (padding lanes add 0), and the two derivative lanes. It is
held to the plain VJP at the card tests' tolerance: 1e-5 of the
reference's largest entry plus 1e-6.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_rqs_grad_lanes.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from posteriflow_torch.ops import rqs as trqs
from posteriflow_torch.ops import rqs_cuda
from test_torch_rqs_grad import TAIL, _inputs, _within

D = 7


def _f32(v: float) -> float:
    return float(np.float32(v))


def _lane_knots(v, k, min_bin, bound):
    """One axis over the K lanes (v [..., K], lane j in column j): the
    lanes' softmax entries p and knots (knot j+1 on lane j, the pinned end
    B on lane K-1), as lane_knot forms them."""
    scale = _f32(1.0 - min_bin * k)
    e = torch.exp(v - torch.amax(v, dim=-1, keepdim=True))
    total = torch.zeros_like(e[..., 0])
    for j in range(k):                      # every lane gathers e_0..e_K-1
        total = total + e[..., j]
    p = e / total[..., None]
    size = _f32(min_bin) + scale * p
    knot = torch.full_like(v, bound)
    cs = torch.zeros_like(total)
    for j in range(k - 1):                  # lane j keeps the cumsum to j
        cs = cs + size[..., j]
        knot[..., j] = cs * _f32(2.0 * bound) - bound
    return p, knot, scale


def group_width(k: int) -> int:
    """The lanes of a spline's group: K rounded up to a power of two."""
    g = 1
    while g < k:
        g *= 2
    return g


def _butterfly(v, k):
    """The group sum as group_sum takes it over the G lanes of the group,
    the padding lanes K..G-1 holding 0: xor shuffles G/2, ..., 1."""
    g = group_width(k)
    v = torch.cat([v, v.new_zeros(*v.shape[:-1], g - k)], dim=-1)
    lanes = torch.arange(g)
    off = g // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v[..., :k]


def lane_grad(x, raw, bias, g_out, g_logdet, k, bound=TAIL):
    """(g_x [N, D], g_raw [N, D, 3K-1]) in rqs_grad's order."""
    u_all = raw if bias is None else raw + bias
    w, h, u = u_all[..., :k], u_all[..., k:2 * k], u_all[..., 2 * k:]
    lanes = torch.arange(k)
    g_y, g_l = g_out, g_logdet[:, None].expand_as(x)
    inside = x.abs() <= bound
    vs = x.clamp(-bound, bound)

    p_w, kx, scale_w = _lane_knots(w, k, trqs.DEFAULT_MIN_BIN_WIDTH, bound)
    p_h, ky, scale_h = _lane_knots(h, k, trqs.DEFAULT_MIN_BIN_HEIGHT, bound)
    idx = (vs[..., None] >= kx[..., :k - 1]).sum(-1)
    dv = trqs.DEFAULT_MIN_DERIVATIVE + F.softplus(u)
    lo = (idx - 1).clamp(min=0)[..., None]
    hi = idx[..., None]
    x_lo = torch.where(idx > 0, kx.gather(-1, lo)[..., 0], -bound)
    y_lo = torch.where(idx > 0, ky.gather(-1, lo)[..., 0], -bound)
    x_hi = kx.gather(-1, hi)[..., 0]
    y_hi = ky.gather(-1, hi)[..., 0]
    d_lo = torch.where(idx > 0, dv.gather(-1, lo.clamp(max=k - 2))[..., 0],
                       1.0)
    d_hi = torch.where(idx < k - 1, dv.gather(-1, hi.clamp(max=k - 2))[..., 0],
                       1.0)

    # the map: theta by division, the other quotients by reciprocals (the
    # kernel's fast ones are within two ulps of these)
    wb = x_hi - x_lo
    hb = y_hi - y_lo
    iw = 1.0 / wb
    s = hb * iw
    dsum = d_hi + d_lo - 2.0 * s
    theta_raw = (vs - x_lo) / wb
    theta = theta_raw.clamp(0.0, 1.0)
    t1m = 1.0 - theta
    tt = theta * t1m
    denom = s + dsum * tt
    iq = 1.0 / denom
    theta2 = theta * theta
    num = s * theta2 + d_lo * tt
    m = d_hi * theta2 + 2.0 * s * tt + d_lo * (t1m * t1m)

    # its reverse, log dydx = 2 log s + log m - 2 log denom
    gl = torch.where(s * s * m * (iq * iq) >= 1e-30, g_l, 0.0)
    g_num = g_y * hb * iq
    g_m = gl * (1.0 / m)
    g_den = -g_y * hb * num * (iq * iq) - 2.0 * gl * iq
    g_h = g_y * num * iq
    g_s = (g_num * theta2 + g_den * (1.0 - 2.0 * tt)
           + 2.0 * gl * (1.0 / s) + g_m * 2.0 * tt)
    g_dlo = (g_num + g_den) * tt + g_m * (t1m * t1m)
    g_dhi = g_den * tt + g_m * theta2
    g_tt = g_num * d_lo + g_den * dsum + g_m * 2.0 * s
    g_t1m = g_tt * theta + g_m * 2.0 * d_lo * t1m
    g_theta = (g_num * 2.0 * s * theta + g_m * 2.0 * d_hi * theta
               + g_tt * t1m - g_t1m)
    g_th_raw = torch.where((theta_raw >= 0.0) & (theta_raw <= 1.0), g_theta,
                           0.0)
    g_vs = g_th_raw * iw
    g_w = -g_th_raw * theta_raw * iw
    g_h = g_h + g_s * iw
    g_w = g_w - g_s * s * iw
    g_xlo = -g_th_raw * iw - g_w
    g_ylo = g_y - g_h

    # per lane: the gradient on its softmax entries, the Jacobian's dot
    # product by butterfly, the derivative lanes idx-1 and idx
    two_b = _f32(2.0 * bound)
    below = lanes < idx[..., None]
    upto = lanes <= idx[..., None]
    out = []
    for p, scale, c_lo, c_hi in ((p_w, scale_w, g_xlo, g_w),
                                 (p_h, scale_h, g_ylo, g_h)):
        c_lo = torch.where(idx >= 1, c_lo, 0.0)[..., None]
        c_hi = torch.where(idx + 1 <= k - 1, c_hi, 0.0)[..., None]
        g_p = _f32(scale * two_b) * (torch.where(below, c_lo, 0.0)
                                     + torch.where(upto, c_hi, 0.0))
        dot = _butterfly(p * g_p, k)
        out.append(p * (g_p - dot))
    z = torch.exp(u)
    sg = torch.where(u > 20.0, 1.0, z * (1.0 / (z + 1.0)))
    j = lanes[:k - 1]
    g_u = torch.where((idx[..., None] > 0) & (j == idx[..., None] - 1),
                      g_dlo[..., None] * sg, 0.0)
    g_u = torch.where((idx[..., None] < k - 1) & (j == idx[..., None]),
                      g_dhi[..., None] * sg, g_u)
    g_raw = torch.where(inside[..., None], torch.cat([*out, g_u], dim=-1),
                        0.0)
    return torch.where(inside, g_vs, g_y), g_raw, (kx, ky)


@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("k", rqs_cuda.SUPPORTED_BINS)
def test_lane_order_matches_plain_vjp(k, use_bias):
    """At every K the kernel's lane order gives the plain VJP's gradients
    within 1e-5 of the largest entry plus 1e-6, on x on knots, at ±B, one
    float inside and outside, in both tails, with g_logdet zero on every
    third row; and its knots are the forward's bits."""
    n = 96
    x, raw, bias, g_out, g_ld = _inputs(n, D, k, seed=10 + k,
                                        use_bias=use_bias)
    assert (x > TAIL).any() and (x < -TAIL).any()
    g_x, g_raw, (kx, ky) = lane_grad(x, raw, bias, g_out, g_ld, k)
    xk, yk, _ = trqs._normalize_params(raw if bias is None else raw + bias,
                                       k, TAIL)
    assert torch.equal(kx, xk[..., 1:]) and torch.equal(ky, yk[..., 1:])
    r_x, r_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL,
                                      bias=bias)
    for got, ref in ((g_x, r_x), (g_raw, r_raw)):
        err, ok = _within(got, ref)
        assert ok, (err, float(ref.abs().max()))


def _swap_launches(monkeypatch):
    """Replace both kernels' launches by the plain versions, so that
    RqsForwardFn runs on CPU tensors; returns the backward's launch log."""
    launched = []

    def forward_launch(x, raw, num_bins, tail_bound, inverse, bias):
        u = raw.reshape(*x.shape, 3 * num_bins - 1) + bias
        return trqs.rqs_forward(x, u, num_bins, tail_bound)

    def grad_launch(x, raw, g_out, g_logdet, num_bins, tail_bound, bias):
        launched.append(num_bins)
        g_x, g_raw = trqs.rqs_forward_vjp(
            x, raw.reshape(*x.shape, 3 * num_bins - 1), g_out, g_logdet,
            num_bins, tail_bound, bias=bias)
        return g_x, g_raw.reshape(raw.shape)

    monkeypatch.setattr(rqs_cuda.KERNEL, "launch", forward_launch)
    monkeypatch.setattr(rqs_cuda.GRAD_KERNEL, "_launch", grad_launch)
    return launched


def test_backward_still_checks_upstream_gradients(monkeypatch):
    """RqsForwardFn.backward launches without checking x, raw and bias
    again, but a g_out or g_logdet of the wrong shape or device raises
    ValueError and launches nothing; a float64 g_out is cast, as before;
    through autograd the gradients are the plain VJP's, one launch."""
    launched = _swap_launches(monkeypatch)
    k, n = 4, 12
    x, raw, bias, g_out, g_ld = _inputs(n, 3, k, seed=2)
    raw2 = raw.reshape(n, -1)
    ctx = SimpleNamespace(saved_tensors=(x, raw2, bias), spline=(k, TAIL))
    bad = {"g_out": [(g_out[:-1], g_ld), (g_out.reshape(-1), g_ld),
                     (g_out.to("meta"), g_ld)],
           "g_logdet": [(g_out, g_ld[:-1]), (g_out, g_ld[:, None]),
                        (g_out, g_ld.to("meta"))]}
    with torch.no_grad():
        for name, cases in bad.items():
            for go, gl in cases:
                with pytest.raises(ValueError, match=name):
                    rqs_cuda.RqsForwardFn.backward(ctx, go, gl)
        assert not launched
        g_x, g_raw, *rest = rqs_cuda.RqsForwardFn.backward(
            ctx, g_out.double(), g_ld)
    r_x, r_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL,
                                      bias=bias)
    assert torch.equal(g_x, r_x) and torch.equal(g_raw, r_raw.reshape(n, -1))
    assert rest == [None, None, None] and launched == [k]

    xg = x.clone().requires_grad_(True)
    rg = raw2.clone().requires_grad_(True)
    out, ld = rqs_cuda.RqsForwardFn.apply(xg, rg, k, TAIL, bias)
    torch.autograd.backward((out, ld), (g_out, g_ld))
    assert torch.equal(xg.grad, r_x)
    assert torch.equal(rg.grad, r_raw.reshape(n, -1))
    assert launched == [k, k]
