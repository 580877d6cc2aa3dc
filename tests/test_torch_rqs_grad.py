"""The backward of the forward RQS spline: the plain VJP
(ops/rqs.py rqs_forward_vjp) against finite differences on the CPU, the
wrapper's autograd on CPU tensors, and on the card the CUDA kernel
(csrc/rqs.cu rqs_grad, through ops/rqs_cuda.py) against the plain VJP
(marker `cuda`, skipped without one).

The kernel is not bit-equal to autograd (the softmax's amax and the order
of the sums differ), so each output is held to max |Δ| <= 1e-5 of the
reference's largest |entry| plus 1e-6.

This file imports neither JAX nor the JAX package, so that on a machine
without them it runs with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_rqs_grad.py
"""

import numpy as np
import pytest
import torch

from posteriflow_torch.ops import rqs as trqs
from posteriflow_torch.ops import rqs_cuda

REL_TOL, ABS_TOL = 1e-5, 1e-6
TAIL = 5.0


def _inputs(n, d, k, seed, dtype=torch.float32, device="cpu",
            special=True, use_bias=True):
    """x with |x| up to 6 (tails beyond ±5), raw N(0, 0.7²), a bias
    N(0, 0.5²) (None without `use_bias`), upstream g_out N(0, 1) and g_logdet N(0, 1) with every
    third row 0. With `special`, the first rows put x on the knots of its
    own spline, at exactly ±B and just inside and outside them."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((n, d)) * 2.5, -6.0, 6.0)
    raw = rng.standard_normal((n, d, 3 * k - 1)) * 0.7
    bias = rng.standard_normal(3 * k - 1) * 0.5
    g_out = rng.standard_normal((n, d))
    g_ld = rng.standard_normal(n)
    g_ld[::3] = 0.0
    t = [torch.tensor(a, dtype=dtype, device=device)
         for a in (x, raw, bias, g_out, g_ld)]
    x, raw, bias = t[0], t[1], t[2] if use_bias else None
    if special and n >= 8:
        xk, _, _ = trqs._normalize_params(
            raw[:4] if bias is None else raw[:4] + bias, k, TAIL)
        j = 1 + torch.arange(d, device=device) % (k - 1)
        x[:4] = torch.gather(xk, -1, j[None, :, None].expand(4, d, 1))[..., 0]
        x[4, :] = TAIL
        x[5, :] = -TAIL
        x[6, :] = torch.nextafter(torch.tensor(TAIL, dtype=dtype),
                                  torch.tensor(0.0, dtype=dtype)).item()
        x[7, :] = torch.nextafter(torch.tensor(-TAIL, dtype=dtype),
                                  torch.tensor(-10.0, dtype=dtype)).item()
    return x, raw, bias, t[3], t[4]


class _PlainVjp(torch.autograd.Function):
    """rqs_forward with rqs_forward_vjp as its backward, so that gradcheck
    holds the VJP against finite differences."""

    @staticmethod
    def forward(ctx, x, raw, bias, k):
        ctx.save_for_backward(x, raw, bias)
        ctx.k = k
        return trqs.rqs_forward(x, raw + bias, k, TAIL)

    @staticmethod
    def backward(ctx, g_out, g_ld):
        x, raw, bias = ctx.saved_tensors
        g_x, g_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, ctx.k, TAIL,
                                          bias=bias)
        return g_x, g_raw, None, None


@pytest.mark.parametrize("k", [4, 8])
def test_plain_vjp_against_finite_differences(k):
    """float64, points inside the spline and in the tails (not on knots or
    at ±B, where the logdet's derivative jumps)."""
    x, raw, bias, _, _ = _inputs(6, 3, k, seed=k, dtype=torch.float64,
                                 special=False)
    x.requires_grad_(True)
    raw.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, r: _PlainVjp.apply(a, r, bias, k), (x, raw), eps=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
def test_plain_vjp_is_autograd_of_the_wrapper_on_cpu(use_bias):
    """On CPU tensors rqs_cuda.rqs_forward is differentiable and its
    gradients are rqs_forward_vjp's, bit for bit; the bias gets none."""
    k = 8
    x, raw, bias, g_out, g_ld = _inputs(40, 5, k, seed=3, use_bias=use_bias)
    xg = x.clone().requires_grad_(True)
    rg = raw.clone().requires_grad_(True)
    launched = rqs_cuda.GRAD_KERNEL.launches
    out, ld = rqs_cuda.rqs_forward(xg, rg, k, TAIL, bias=bias)
    torch.autograd.backward((out, ld), (g_out, g_ld))
    g_x, g_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL,
                                      bias=bias)
    assert torch.equal(xg.grad, g_x) and torch.equal(rg.grad, g_raw)
    assert rqs_cuda.GRAD_KERNEL.launches == launched


def test_plain_vjp_tails_and_zero_logdet_gradient():
    """In the tails g_x = g_out and g_raw = 0; with g_logdet = 0 and g_out
    = 0 everything is 0."""
    k = 4
    x, raw, bias, g_out, g_ld = _inputs(12, 3, k, seed=5, special=False)
    x[0] = torch.tensor([6.0, -5.5, 5.0001])
    g_x, g_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL, bias)
    assert torch.equal(g_x[0], g_out[0])
    assert not g_raw[0].any()
    z_x, z_raw = trqs.rqs_forward_vjp(x, raw, torch.zeros_like(g_out),
                                      torch.zeros_like(g_ld), k, TAIL, bias)
    assert not z_x.any() and not z_raw.any()


def _within(got, ref):
    err = float((got - ref).abs().max())
    return err, err <= REL_TOL * float(ref.abs().max()) + ABS_TOL


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [640, 257, 131072])
@pytest.mark.parametrize("k", rqs_cuda.SUPPORTED_BINS)
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
def test_grad_kernel_matches_plain_vjp(cuda_device, use_bias, k, n):
    """rqs_grad<K, BIAS> against rqs_forward_vjp on the same card inputs,
    D = 7, with points on knots, at ±B, just inside and outside, in both
    tails, and rows with g_logdet 0."""
    d = 7
    x, raw, bias, g_out, g_ld = _inputs(n, d, k, seed=n + k,
                                        device=cuda_device, use_bias=use_bias)
    before = rqs_cuda.GRAD_KERNEL.launches
    g_x, g_raw = rqs_cuda.GRAD_KERNEL.launch(
        x, raw.reshape(n, -1), g_out, g_ld, k, TAIL, bias)
    r_x, r_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL,
                                      bias=bias)
    torch.cuda.synchronize()
    assert rqs_cuda.GRAD_KERNEL.launches == before + 1
    for got, ref in ((g_x, r_x), (g_raw.reshape(n, d, -1), r_raw)):
        err, ok = _within(got, ref)
        assert ok, (err, float(ref.abs().max()))


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels(cuda_device):
    """Under grad, rqs_forward on CUDA runs the forward kernel once and the
    backward kernel once, gives the plain version's forward bits and the
    plain VJP's gradients; the bias gets none."""
    k, n, d = 16, 640, 7
    x, raw, bias, g_out, g_ld = _inputs(n, d, k, seed=1, device=cuda_device)
    xg = x.clone().requires_grad_(True)
    rg = raw.clone().requires_grad_(True)
    f0 = rqs_cuda.KERNEL.launches
    b0 = rqs_cuda.GRAD_KERNEL.launches
    out, ld = rqs_cuda.rqs_forward(xg, rg, k, TAIL, bias=bias)
    p_out, p_ld = trqs.rqs_forward(x, raw + bias, k, TAIL)
    assert torch.equal(out, p_out) and torch.equal(ld, p_ld)
    torch.autograd.backward((out, ld), (g_out, g_ld))
    torch.cuda.synchronize()
    assert rqs_cuda.KERNEL.launches == f0 + 1
    assert rqs_cuda.GRAD_KERNEL.launches == b0 + 1
    r_x, r_raw = trqs.rqs_forward_vjp(x, raw, g_out, g_ld, k, TAIL, bias)
    for got, ref in ((xg.grad, r_x), (rg.grad, r_raw)):
        assert _within(got, ref)[1]
