"""The conditioner's fused hidden-layer tail (ops/conditioner_cuda.py,
csrc/conditioner.cu) and Conditioner.project's use of it.

On the CPU: the plain version, as project now runs it, gives the bits of
the op sequence project ran before (`_eager_project` below) at the widths
of the port's flows, with a context per event broadcast over its draws
and with one per row; the dispatch takes the plain version for CPU
tensors and under autograd and counts `conditioner_eager`; the wrapper
refuses what the kernel does not take. The tests marked `cuda` hold the
kernel bit-equal to the eager ops on the card (every bf16 input of the
GELU, and project at the served paths' shapes), and count its launches;
they skip without a card.

This file imports neither JAX nor the JAX package, so that it runs on the
card too (python -m pytest --noconftest tests/test_torch_conditioner_cuda.py).
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from posteriflow_torch.models.flow import Conditioner, CouplingNSF
from posteriflow_torch.ops import conditioner_cuda as cc
from posteriflow_torch.utils import logging as plog
from posteriflow_torch.utils.precision import dense, gelu

ROOT = Path(__file__).resolve().parents[1]
N_ID, CTX, N_TR, K = 8, 48, 7, 16


@pytest.fixture(autouse=True)
def fresh_recorder():
    plog.reset()
    yield
    plog.reset()


def _eager_project(cond: Conditioner, x_id, context):
    """Conditioner.project as the port ran it op by op before the fused
    tail: the reference every way of project is held to."""
    dt = cond.compute_dtype
    h = gelu(dense(cond.in_x, x_id, dt) + dense(cond.in_ctx, context, dt))
    for i in range(cond.n_mid):
        h = gelu(dense(getattr(cond, f"mid_{i}"), h, dt))
    out = F.linear(h.to(cond.out.weight.dtype), cond.out.weight,
                   cond.out.bias)
    return out.reshape(*out.shape[:-1], cond.n_transform, -1)


def _conditioner(hidden, n_hidden_layers=2, seed=0, device="cpu"):
    """A bf16 conditioner with every weight drawn (the output projection
    off its zero init), so that every layer moves the result."""
    torch.manual_seed(seed)
    cond = Conditioner(N_ID, CTX, N_TR, K, hidden, n_hidden_layers)
    with torch.no_grad():
        for prm in cond.parameters():
            prm.copy_(torch.randn_like(prm) * prm.shape[-1] ** -0.5)
    return cond.to(device)


def _inputs(rows, context, seed=1, device="cpu"):
    """x_id and a context: `per_row` [rows, ·] each; `broadcast` two
    events of `rows` draws, [2, rows, ·] against [2, 1, ·]."""
    g = torch.Generator().manual_seed(seed)
    if context == "per_row":
        x = torch.randn(rows, N_ID, generator=g)
        c = torch.randn(rows, CTX, generator=g)
    else:
        x = torch.randn(2, rows, N_ID, generator=g)
        c = torch.randn(2, 1, CTX, generator=g)
    return x.to(device), (3.0 * c).to(device)


# ── on the CPU ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("rows", [641, 2048])
@pytest.mark.parametrize("context", ["broadcast", "per_row"])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_project_is_bit_equal_to_the_eager_op_sequence(hidden, context,
                                                        rows):
    cond = _conditioner(hidden)
    x, c = _inputs(rows, context)
    with torch.no_grad():
        got = cond.project(x, c)
        want = _eager_project(cond, x, c)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_hidden_layers", [1, 3])
def test_one_and_three_hidden_layers_cast_at_the_last(n_hidden_layers):
    """The last hidden layer's tail writes the output projection's dtype,
    whether it is the first layer or the third."""
    cond = _conditioner(64, n_hidden_layers)
    x, c = _inputs(300, "broadcast")
    with torch.no_grad():
        assert torch.equal(cond.project(x, c), _eager_project(cond, x, c))


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_plain_tail_is_gelu_of_the_two_adds(out_dtype):
    g = torch.Generator().manual_seed(3)
    p = (4 * torch.randn(5, 7, 64, generator=g)).to(torch.bfloat16)
    b = torch.randn(64, generator=g).to(torch.bfloat16)
    q = torch.randn(5, 1, 64, generator=g).to(torch.bfloat16)
    got = cc.bias_gelu_plain(p, b, q, out_dtype)
    want = gelu(p + b + q)
    assert torch.equal(got, want if out_dtype is None
                       else want.to(out_dtype))
    assert torch.equal(cc.bias_gelu(p, b, q, out_dtype), got)


def _flow(hidden=32):
    torch.manual_seed(4)
    flow = CouplingNSF(features=15, context_features=CTX, num_layers=3,
                       hidden=hidden, num_bins=4)
    with torch.no_grad():
        for prm in flow.parameters():
            prm.add_(0.05 * torch.randn_like(prm))
    return flow


def _counts():
    return plog.snapshot()["pf.flow.conditioner"]["counts"]


def test_cpu_calls_take_the_plain_path_and_count_eager():
    flow = _flow()
    z = torch.randn(2, 50, 15)
    c = torch.randn(2, CTX)
    before = cc.KERNEL.launches
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        flow.sample_with_log_prob(z, c[:, None, :])
    assert _counts() == {"conditioner_eager": 3}
    assert cc.KERNEL.launches == before


def test_calls_under_grad_take_the_plain_path_and_count_eager():
    """A training call (grad on, weights that require it) runs the
    differentiable eager ops: the gradient reaches every hidden layer."""
    flow = _flow()
    y = torch.rand(16, 15) * 2 - 1
    c = torch.randn(16, CTX)
    before = cc.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU]):
        flow.log_prob(y, c).sum().backward()
    assert _counts() == {"conditioner_eager": 3}
    assert cc.KERNEL.launches == before
    cond = flow._cond(0)
    for layer in (cond.in_x, cond.in_ctx, cond.mid_0):
        assert layer.weight.grad is not None
        assert float(layer.weight.grad.abs().sum()) > 0


def test_the_dispatch_reads_device_dtype_and_grad():
    p = torch.zeros(4, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    assert not cc.kernel_takes(p, w)                 # a CPU tensor
    assert not cc.kernel_takes(p.to("meta"), None)   # neither CPU nor CUDA
    assert not cc.kernel_takes(p.float())            # float32


@pytest.mark.parametrize("p_shape, c_shape, rep", [
    ((2, 5, 16), (2, 1, 16), 5),
    ((7, 16), (7, 16), 1),
    ((7, 16), (1, 16), 7),
    ((3, 4, 5, 16), (3, 1, 1, 16), 20),
    ((3, 4, 5, 16), (3, 4, 5, 16), 1),
], ids=["events", "rows", "one", "two_broadcast_dims", "rows_3d"])
def test_context_rows_follow_the_leading_dims(p_shape, c_shape, rep):
    assert cc.context_rep(p_shape, c_shape) == rep


@pytest.mark.parametrize("p_shape, c_shape", [
    ((2, 5, 16), (5, 16)), ((2, 5, 16), (2, 5, 8)),
    ((3, 4, 5, 16), (3, 1, 5, 16))])
def test_a_context_that_is_not_row_wise_is_refused(p_shape, c_shape):
    with pytest.raises(ValueError, match="does not broadcast row-wise"):
        cc.context_rep(p_shape, c_shape)


def _bf(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("args, kwargs, exc, match", [
    ((_bf(4, 16).float(), _bf(16)), {}, TypeError, "p in torch.float32"),
    ((_bf(4, 16), _bf(16).half()), {}, TypeError, "bias in torch.float16"),
    ((_bf(4, 16), _bf(16), _bf(4, 16).float()), {}, TypeError,
     "context in torch.float32"),
    ((_bf(4, 16), _bf(16)), {"out_dtype": torch.float16}, TypeError,
     "not torch.float16"),
    ((_bf(4, 12), _bf(12)), {}, ValueError, "got H=12"),
    ((_bf(4, 4096), _bf(4096)), {}, ValueError, "got H=4096"),
    ((_bf(4, 16), _bf(8)), {}, ValueError, r"bias must be \[16\]"),
    ((_bf(2, 3, 16), _bf(16), _bf(3, 16)), {}, ValueError,
     "does not broadcast"),
    ((_bf(4, 16), _bf(16)), {}, ValueError, "got p on cpu"),
], ids=["p_f32", "bias_f16", "ctx_f32", "out_f16", "h12", "h4096",
        "bias_shape", "ctx_shape", "cpu"])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(
        args, kwargs, exc, match):
    before = cc.KERNEL.launches
    with pytest.raises(exc, match=match):
        cc.KERNEL.launch(*args, **kwargs)
    assert cc.KERNEL.launches == before


def test_build_is_keyed_by_its_own_source_and_flags():
    from posteriflow_torch.ops import rqs_cuda
    from posteriflow_torch.utils import native
    lib = cc.KERNEL.path
    assert lib.parent == native.BUILD_DIR
    assert lib.name.startswith("libconditioner_")
    assert lib != rqs_cuda.KERNEL.path
    cmd = " ".join(cc.KERNEL.command("nvcc", Path("o.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd and cc.SOURCE.exists()
    assert "-fmad=false" not in cmd and "fast-math" not in cmd


# ── on the card ───────────────────────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_card_every_bf16_input_of_the_gelu(cuda_device, out_dtype):
    """All 65,536 bf16 bit patterns through the kernel with a zero bias,
    against the eager ops on the card: the GELU chain, tanhf included, is
    bit-equal for every input it can meet (NaNs compared as NaNs)."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32)
    p = bits.to(torch.int16).view(torch.bfloat16).reshape(-1, 256)
    p = p.to(cuda_device)
    b = torch.zeros(256, dtype=torch.bfloat16, device=cuda_device)
    got = cc.KERNEL.launch(p, b, out_dtype=out_dtype)
    want = cc.bias_gelu_plain(p, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])


def _release_flow(name, device):
    if name == "npe_r7":
        from posteriflow_torch.inference.pipeline import load_model
        return load_model(ROOT / "model_release/npe_r7_best",
                          device=device).model.flow
    from posteriflow_torch.train.checkpoints import load_long_bns
    return load_long_bns(ROOT / "model_release/long_bns_v4",
                         device=device)[0].flow


def _card_inputs(flow, events, draws, device, seed):
    """x_id and a context per event, broadcast over its draws when
    `draws` is given, else one per row."""
    g = torch.Generator(device).manual_seed(seed)
    cond = flow._cond(0)
    c_in = cond.in_ctx.in_features
    if draws is None:
        return (torch.randn(events, flow.n_id, generator=g, device=device),
                torch.randn(events, c_in, generator=g, device=device))
    return (torch.randn(events, draws, flow.n_id, generator=g,
                        device=device),
            torch.randn(events, 1, c_in, generator=g, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("flow_name, events, draws", [
    ("npe_r7", 8, 16384),          # 131,072 x 256, a sampling request
    ("long_bns_v4", 250, 400),     # 100,000 x 128, a long-BNS request
    ("npe_r7", 4096, None),        # importance's density rows
    ("npe_r7", 256, None),         # validation's NLL rows
    ("npe_r7", 641, None),         # ragged
    ("npe_r7", 1, 641),
    ("long_bns_v4", 641, None),
])
def test_card_project_is_bit_equal_to_the_eager_ops(cuda_device, flow_name,
                                                     events, draws):
    flow = _release_flow(flow_name, cuda_device)
    assert flow._cond(0).compute_dtype == torch.bfloat16
    x, c = _card_inputs(flow, events, draws, cuda_device, seed=events)
    for i in range(flow.num_layers):
        cond = flow._cond(i)
        with torch.no_grad():
            before = cc.KERNEL.launches
            got = cond.project(x, c)
            assert cc.KERNEL.launches == before + 1 + cond.n_mid
            want = _eager_project(cond, x, c)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"layer {i}"


def _profiled(fn):
    torch.cuda.synchronize()
    plog.reset()
    before = cc.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    return cc.KERNEL.launches - before, _counts()


@pytest.mark.cuda
@pytest.mark.parametrize("flow_name, events, draws, launches", [
    ("npe_r7", 8, 16384, 20), ("long_bns_v4", 250, 400, 12)])
def test_card_a_request_launches_two_a_layer(cuda_device, flow_name, events,
                                             draws, launches):
    flow = _release_flow(flow_name, cuda_device)
    g = torch.Generator(cuda_device).manual_seed(7)
    z = torch.randn(events, draws, flow.features, generator=g,
                    device=cuda_device)
    c = torch.randn(events, 1, flow._cond(0).in_ctx.in_features,
                    generator=g, device=cuda_device)
    with torch.no_grad():
        n, counts = _profiled(lambda: flow.sample_with_log_prob(z, c))
    assert n == launches
    assert counts == {"conditioner_fused": flow.num_layers}


@pytest.mark.cuda
def test_card_a_training_step_launches_none(cuda_device):
    """The training NLL and its backward on the card (grad on, weights
    that require it): the eager ops, no launch, a gradient."""
    flow = _release_flow("npe_r7", cuda_device)
    x, c = _card_inputs(flow, 128, None, cuda_device, seed=9)
    y = torch.tanh(torch.randn(128, flow.features, device=cuda_device))
    flow.zero_grad()
    n, counts = _profiled(
        lambda: flow.log_prob(y, c).mean().backward())
    assert n == 0
    assert counts == {"conditioner_eager": flow.num_layers}
    assert float(flow._cond(0).in_x.weight.grad.abs().sum()) > 0
