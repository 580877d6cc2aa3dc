"""Two faults of the port against the JAX reference, repaired:

1. The CUDA spline kernel writes its outputs through raw pointers, so on
   the card autograd saw no graph and dropped gradients without a word.
   The forward direction now runs under grad as an autograd Function whose
   backward is a kernel too (csrc/rqs.cu rqs_grad); the inverse, which no
   path differentiates, and a bias that requires grad (it is a constant)
   raise on CUDA inputs while grad is enabled (`cuda` tests, skipped
   without a card). The plain path, which the CPU takes, stays
   differentiable.
2. torch lets cuDNN run float32 convolutions in TF32 by default, and a
   caller may allow TF32 matmuls; the JAX reference computes them in
   float32. The port's float32 convs and matmuls now run inside
   utils/precision.fp32_exact, which turns TF32 off and restores the
   caller's settings, and the trainer differentiates them inside it too
   (train/trainer.py `backward`): loss.backward() runs after the forward's
   context has closed. Checked on the CPU by recording the switches each
   conv and matmul of the encoder and the flow sees, forward and backward.

This file imports neither JAX nor the JAX package, so that on a machine
without them it runs with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_repairs.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from posteriflow_torch.models.encoder import ConvStem
from posteriflow_torch.models.npe import LeanNPE, NPEConfig
from posteriflow_torch.physics.simulator import EventBatch, SimConfig
from posteriflow_torch.prior import PriorConfig, sample_batch
from posteriflow_torch.train.trainer import (TrainConfig, batch_nll,
                                             init_state, train_step)
from posteriflow_torch.ops import rqs as trqs
from posteriflow_torch.ops import rqs_cuda
from posteriflow_torch.utils.precision import fp32_exact

K = 4


def _spline_inputs(device, dtype=torch.float32, requires_grad=False):
    rng = np.random.default_rng(0)
    x = torch.tensor(np.clip(rng.standard_normal((6, 3)) * 2.0, -4, 4),
                     dtype=dtype, device=device)
    raw = torch.tensor(rng.standard_normal((6, 3, 3 * K - 1)) * 0.5,
                       dtype=dtype, device=device)
    bias = torch.tensor(rng.standard_normal(3 * K - 1) * 0.3, dtype=dtype,
                        device=device)
    for t in (x, raw, bias):
        t.requires_grad_(requires_grad)
    return x, raw, bias


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("which", ["x", "raw", "bias"])
def test_kernel_refuses_grad_on_card(cuda_device, inverse, which):
    """The inverse with any of x, raw or bias requiring grad, and the
    forward with the bias requiring grad, under grad: a RuntimeError and no
    launch; under no_grad the kernel runs. The forward with x or raw
    requiring grad runs both kernels, and its gradients are the plain
    VJP's within 1e-5 of the largest entry plus 1e-6."""
    x, raw, bias = _spline_inputs(cuda_device)
    leaf = dict(x=x, raw=raw, bias=bias)[which]
    leaf.requires_grad_(True)
    fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
    before = rqs_cuda.KERNEL.launches
    if not inverse and which != "bias":
        grads = rqs_cuda.GRAD_KERNEL.launches
        out, logdet = fn(x, raw, K, bias=bias)
        g_out = torch.linspace(-1.0, 1.0, out.numel(),
                               device=cuda_device).view_as(out)
        g_ld = torch.linspace(0.5, -0.5, logdet.numel(), device=cuda_device)
        torch.autograd.backward((out, logdet), (g_out, g_ld))
        torch.cuda.synchronize()
        assert rqs_cuda.KERNEL.launches == before + 1
        assert rqs_cuda.GRAD_KERNEL.launches == grads + 1
        ref = trqs.rqs_forward_vjp(x.detach(), raw.detach(), g_out, g_ld, K,
                                   bias=bias)[0 if which == "x" else 1]
        err = float((leaf.grad - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()) + 1e-6, err
        return
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x, raw, K, bias=bias)
    assert rqs_cuda.KERNEL.launches == before
    with torch.no_grad():
        out, logdet = fn(x, raw, K, bias=bias)
    torch.cuda.synchronize()
    assert rqs_cuda.KERNEL.launches == before + 1
    assert bool(torch.isfinite(out).all() and torch.isfinite(logdet).all())


def _second_derivative_through_forward_fn(x, raw, bias):
    """d/dx of (sum of g_x²) + sum(x), with g_x = d logdet / dx taken
    through RqsForwardFn with create_graph: the first term needs the
    backward kernel's own derivative, which it does not have."""
    raw2 = raw.reshape(x.shape[0], -1)
    _, logdet = rqs_cuda.RqsForwardFn.apply(x, raw2, K, 5.0, bias)
    (g_x,) = torch.autograd.grad(logdet.sum(), x, create_graph=True)
    ((g_x ** 2).sum() + x.sum()).backward()


@pytest.mark.cuda
def test_kernel_refuses_double_backward_on_card(cuda_device):
    """A second derivative through the spline kernels raises instead of
    dropping the backward kernel's term (whose outputs carry no graph)."""
    x, raw, bias = _spline_inputs(cuda_device)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="create_graph"):
        _second_derivative_through_forward_fn(x, raw, bias)


def test_forward_fn_refuses_double_backward(monkeypatch):
    """RqsForwardFn with the kernels' launches replaced by the plain
    versions (so that it runs on CPU tensors): a second derivative raises.
    Were it let through, the backward's detached outputs would give
    x.grad = 1 from the sum(x) term alone, without a word."""
    def forward_launch(x, raw, num_bins, tail_bound, inverse, bias):
        u = raw.reshape(*x.shape, 3 * num_bins - 1) + bias
        return trqs.rqs_forward(x, u, num_bins, tail_bound)

    def grad_launch(x, raw, g_out, g_logdet, num_bins, tail_bound, bias):
        g_x, g_raw = trqs.rqs_forward_vjp(
            x, raw.reshape(*x.shape, 3 * num_bins - 1), g_out, g_logdet,
            num_bins, tail_bound, bias=bias)
        return g_x.detach(), g_raw.detach().reshape(raw.shape)

    monkeypatch.setattr(rqs_cuda.KERNEL, "_launch", forward_launch)
    monkeypatch.setattr(rqs_cuda.GRAD_KERNEL, "_launch", grad_launch)
    x, raw, bias = _spline_inputs("cpu")
    x.requires_grad_(True)
    # one derivative is the plain VJP's
    raw2 = raw.reshape(x.shape[0], -1)
    _, logdet = rqs_cuda.RqsForwardFn.apply(x, raw2, K, 5.0, bias)
    (g_x,) = torch.autograd.grad(logdet.sum(), x)
    ref = trqs.rqs_forward_vjp(x, raw, torch.zeros_like(x),
                               torch.ones(x.shape[0]), K, bias=bias)[0]
    assert torch.equal(g_x, ref)
    with pytest.raises(RuntimeError, match="create_graph"):
        _second_derivative_through_forward_fn(x, raw, bias)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_plain_path_is_differentiable_on_cpu(inverse):
    """On CPU tensors the wrapper is the plain version on raw + bias, and
    gradcheck passes on it in float64 for x, raw and bias."""
    x, raw, bias = _spline_inputs("cpu", torch.float64, requires_grad=True)
    fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward

    def f(a, r, b):
        out, logdet = fn(a, r, K, bias=b)
        return out, logdet

    assert torch.autograd.gradcheck(f, (x, raw, bias), eps=1e-6, atol=1e-5)


class _Recorder:
    """Wraps a torch.nn.functional op and records the TF32 switches it
    runs under."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = []

    def __call__(self, *args, **kwargs):
        self.seen.append((args[0].dtype, torch.backends.cudnn.allow_tf32,
                          torch.get_float32_matmul_precision()))
        return self.fn(*args, **kwargs)


@pytest.fixture
def tf32_on():
    """The global switches as a caller may leave them: TF32 allowed for
    cuDNN (torch's default) and for matmuls."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield
    torch.backends.cudnn.allow_tf32 = conv
    torch.set_float32_matmul_precision(mm)


def test_float32_stem_runs_with_tf32_off(monkeypatch, tf32_on):
    rec = _Recorder(F.conv1d)
    monkeypatch.setattr(F, "conv1d", rec)
    stem = ConvStem(d_model=8, dtype=torch.float32)
    stem(torch.randn(2, 16384))
    assert len(rec.seen) == stem.n_convs
    assert all(s == (torch.float32, False, "highest") for s in rec.seen)
    # the caller's switches are back
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.parametrize("enc", ["coherent", "conv"])
def test_float32_products_of_the_model_run_with_tf32_off(monkeypatch,
                                                         tf32_on, enc):
    """Every float32 linear layer and conv of encode, sampling and NLL
    (encoder, conditioners, output projections) sees TF32 off."""
    cfg = NPEConfig(context_dim=16, rank_dim=4, flow_layers=2,
                    flow_hidden=16, flow_bins=4, d_model=16, enc_layers=1,
                    enc_heads=2, encoder_type=enc, psd_cond=True,
                    encoder_dtype="float32", flow_dtype="float32")
    model = LeanNPE(cfg).eval()
    lin, conv = _Recorder(F.linear), _Recorder(F.conv1d)
    monkeypatch.setattr(F, "linear", lin)
    monkeypatch.setattr(F, "conv1d", conv)
    with torch.no_grad():
        ctx = model.encode(torch.randn(1, 3, 16384), torch.zeros(1, 3, 16))
        rank = torch.zeros(1, dtype=torch.long)
        model.sample_from_context(ctx, rank, 8,
                                  generator=torch.Generator().manual_seed(0))
        model.nll_from_context(ctx, torch.full((1, 11), 10.0), rank)
    f32 = [s for s in lin.seen + conv.seen if s[0] == torch.float32]
    assert len(f32) > 10 and len(conv.seen) == 4
    assert all(s[1:] == (False, "highest") for s in f32), set(f32)
    assert torch.get_float32_matmul_precision() == "high"


def test_fp32_exact_restores_after_an_error(tf32_on):
    with pytest.raises(ValueError):
        with fp32_exact():
            assert torch.backends.cudnn.allow_tf32 is False
            raise ValueError("inside")
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.get_float32_matmul_precision() == "high"


class _BackwardRecorder:
    """Wraps a torch.nn.functional op so that the backward pass records the
    TF32 switches in force when it reaches the op's output."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = []

    def __call__(self, *args, **kwargs):
        seen = self.seen

        class Tap(torch.autograd.Function):
            @staticmethod
            def forward(ctx, out):
                return out.view_as(out)

            @staticmethod
            def backward(ctx, g):
                seen.append((g.dtype, torch.backends.cudnn.allow_tf32,
                             torch.get_float32_matmul_precision()))
                return g

        return Tap.apply(self.fn(*args, **kwargs))


def test_float32_products_are_differentiated_with_tf32_off(monkeypatch,
                                                           tf32_on):
    """A train step of a float32 model: every float32 linear layer and conv
    is differentiated with TF32 off, and the caller's switches are back
    afterwards; a bare loss.backward() would have run under them."""
    cfg = TrainConfig(
        npe=NPEConfig(context_dim=16, rank_dim=4, flow_layers=2,
                      flow_hidden=16, flow_bins=4, d_model=16, enc_layers=1,
                      enc_heads=2, encoder_type="coherent", psd_cond=True,
                      encoder_dtype="float32", flow_dtype="float32"),
        sim=SimConfig(prior=PriorConfig(max_signals=2)), batch_size=2,
        warmup_steps=1, total_steps=10)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    params, n_sig = sample_batch(2, cfg.sim.prior, gen, "cpu")
    batch = EventBatch(strain=torch.randn(2, 3, 16384, generator=gen),
                       params=params, n_sig=n_sig, net_snr=torch.ones(2),
                       sig_snr=torch.ones(2, 2), asd_bands=torch.zeros(2, 3,
                                                                        16),
                       det_mask=torch.ones(2, 3))
    lin, conv = _BackwardRecorder(F.linear), _BackwardRecorder(F.conv1d)
    monkeypatch.setattr(F, "linear", lin)
    monkeypatch.setattr(F, "conv1d", conv)
    train_step(state, batch)
    f32 = [s for s in lin.seen + conv.seen if s[0] == torch.float32]
    assert len(conv.seen) == 4 and len(f32) > 10
    assert all(s[1:] == (False, "highest") for s in f32), set(f32)
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.get_float32_matmul_precision() == "high"
    lin.seen.clear()
    batch_nll(state.model, batch).backward()
    assert {s[1:] for s in lin.seen} == {(True, "high")}
