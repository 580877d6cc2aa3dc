"""Two faults of the port against the JAX reference, repaired:

1. The CUDA spline kernel writes its outputs through raw pointers, so on
   the card autograd saw no graph and dropped gradients without a word.
   The wrapper now raises on CUDA inputs that require grad while grad is
   enabled (a `cuda` test, skipped without a card); the plain path, which
   the CPU takes, stays differentiable.
2. torch lets cuDNN run float32 convolutions in TF32 by default, and a
   caller may allow TF32 matmuls; the JAX reference computes them in
   float32. The port's float32 convs and matmuls now run inside
   utils/precision.fp32_exact, which turns TF32 off and restores the
   caller's settings. Checked on the CPU by recording the switches each
   conv and matmul of the encoder and the flow sees.

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
    """Any of x, raw or bias requiring grad, with grad enabled: a
    RuntimeError and no launch. Under no_grad the kernel runs."""
    x, raw, bias = _spline_inputs(cuda_device)
    dict(x=x, raw=raw, bias=bias)[which].requires_grad_(True)
    fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
    before = rqs_cuda.KERNEL.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x, raw, K, bias=bias)
    assert rqs_cuda.KERNEL.launches == before
    with torch.no_grad():
        out, logdet = fn(x, raw, K, bias=bias)
    torch.cuda.synchronize()
    assert rqs_cuda.KERNEL.launches == before + 1
    assert bool(torch.isfinite(out).all() and torch.isfinite(logdet).all())


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
