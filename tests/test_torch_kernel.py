"""The CUDA RQS kernel's build, binding and wrapper (ops/rqs_cuda.py,
csrc/rqs.cu). The wrapper takes the plain version on CPU tensors and never
falls back on a CUDA one; the kernel itself runs only on a card (marker
`cuda`, skipped without one).

This file imports neither JAX nor the JAX package, so that on a machine
without them it runs with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernel.py
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from posteriflow_torch.ops import rqs as trqs
from posteriflow_torch.ops import rqs_cuda


def _inputs(k, shape=(300, 5), seed=0):
    """|x| up to 6 (some in the identity tails beyond ±5), raw N(0, 0.7²)."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(shape) * 2.5, -6.0, 6.0).astype(np.float32)
    raw = (rng.standard_normal(shape + (3 * k - 1,)) * 0.7).astype(np.float32)
    return x, raw


def _torch_fn(inverse):
    return trqs.rqs_inverse if inverse else trqs.rqs_forward


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_wrapper_takes_plain_version_on_cpu(inverse):
    """On CPU tensors the wrapper returns the plain version's result
    exactly and launches nothing."""
    k = 8
    x, raw = (torch.from_numpy(a) for a in _inputs(k, seed=7))
    before = rqs_cuda.KERNEL.launches
    w_fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
    wo, wl = w_fn(x, raw, k)
    po, pl_ = _torch_fn(inverse)(x, raw, k)
    assert torch.equal(wo, po) and torch.equal(wl, pl_)
    assert rqs_cuda.KERNEL.launches == before


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_wrapper_bias_on_cpu_is_plain_on_raw_plus_bias(inverse):
    """bias= on CPU tensors is the plain version on raw + bias, bit for
    bit, and launches nothing."""
    k = 16
    x, raw = (torch.from_numpy(a) for a in _inputs(k, shape=(40, 7), seed=9))
    bias = torch.from_numpy((np.random.default_rng(10).standard_normal(
        3 * k - 1) * 0.5).astype(np.float32))
    before = rqs_cuda.KERNEL.launches
    w_fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
    wo, wl = w_fn(x, raw, k, bias=bias)
    po, pl_ = _torch_fn(inverse)(x, raw + bias, k)
    assert torch.equal(wo, po) and torch.equal(wl, pl_)
    assert rqs_cuda.KERNEL.launches == before


@pytest.mark.parametrize("n", [1, 3, 640, 641, 5000, 131072])
@pytest.mark.parametrize("k", rqs_cuda.SUPPORTED_BINS)
@pytest.mark.parametrize("d", [5, 7])
def test_tile_plan(d, k, n):
    """Tiles are whole multiples of 4 rows (16-B aligned bulk copies),
    cover the N rows, fit two blocks of two stages in an SM's shared
    memory, and the grid is persistent: no more blocks than tiles or than
    two an SM."""
    sm = 132
    p = rqs_cuda.tile_plan(n, d, k, sm)
    r = 3 * k - 1
    assert p.rows_per_tile % 4 == 0 and p.rows_per_tile >= 4
    assert p.rows_per_tile * d <= rqs_cuda.THREADS     # a spline a thread
    assert p.full_tiles * p.rows_per_tile + p.tail_rows == n
    assert 0 <= p.tail_rows < p.rows_per_tile
    assert p.stage_bytes == 4 * p.rows_per_tile * d * (r + 1)   # raw, x
    assert p.stage_bytes % 16 == 0
    assert p.smem_bytes == rqs_cuda.smem_bytes(p.rows_per_tile, d, k)
    assert p.smem_bytes >= rqs_cuda.STAGES * p.stage_bytes
    assert p.smem_bytes <= rqs_cuda.SMEM_PER_BLOCK
    assert 2 * (p.smem_bytes + rqs_cuda.SMEM_RESERVED) \
        <= rqs_cuda.SMEM_PER_SM
    n_tiles = p.full_tiles + (p.tail_rows > 0)
    assert p.grid == min(n_tiles, 2 * sm)
    if d == 7 and k == 16:                  # the flagship: 36 rows, 48 KB
        assert (p.rows_per_tile, p.stage_bytes) == (36, 48384)


def test_tile_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError):
        rqs_cuda.tile_plan(100, 7, 10, 132)          # no such instance
    with pytest.raises(ValueError):
        rqs_cuda.tile_plan(100, 400, 32, 132)        # 4 rows > 227 KB
    assert rqs_cuda.tile_plan(100, 100, 16, 132).rows_per_tile == 4


def test_ptxas_report_is_read_per_instance():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_18rqs_tileILi16ELb1ELb1EEEvPKfS2_S2_PfS3_iiif' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_18rqs_tileILi16ELb1ELb1EEEvPKfS2_S2_PfS3_iiif\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, 412 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_18rqs_tileILi4ELb0ELb0EEEvPKfS2_S2_PfS3_iiif' "
        "for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 412 bytes cmem[0]\n")
    assert rqs_cuda.ptxas_instances(log) == [
        dict(k=16, inverse=True, bias=True, stack=0, spill_stores=0,
             spill_loads=0, registers=96),
        dict(k=4, inverse=False, bias=False, stack=8, spill_stores=4,
             spill_loads=4, registers=40)]


def test_wrapper_refuses_other_devices_and_cpu_launch():
    k = 8
    x, raw = (torch.from_numpy(a) for a in _inputs(k, seed=8))
    with pytest.raises(ValueError):
        rqs_cuda.rqs_forward(x.to("meta"), raw.to("meta"), k)
    with pytest.raises(ValueError):          # the kernel never takes CPU
        rqs_cuda.KERNEL.launch(x, raw.reshape(x.shape[0], -1), k, 5.0,
                               inverse=False)


def test_find_nvcc_order_and_failure(tmp_path, monkeypatch):
    """nvcc comes from $CUDA_HOME first, then $PATH; none -> RuntimeError."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert rqs_cuda.find_nvcc(default_home=str(tmp_path / "none")) \
        == str(nvcc)
    monkeypatch.delenv("CUDA_HOME")
    monkeypatch.setenv("PATH", str(home / "bin"))
    assert rqs_cuda.find_nvcc(default_home=str(tmp_path / "none")) \
        == str(nvcc)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rqs_cuda.find_nvcc(default_home=str(tmp_path / "none"))


def test_build_command_and_library_name():
    """Route (b): a plain-C shared library for sm_90a, built into the
    git-ignored _build directory under a name keyed by the source."""
    cmd = rqs_cuda.build_command("nvcc", Path("out.so"))
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    for flag in ("-O3", "-shared", "-Xcompiler -fPIC"):
        assert flag in joined
    assert cmd[-1] == str(rqs_cuda.SOURCE) and rqs_cuda.SOURCE.exists()
    lib = rqs_cuda.library_path()
    assert lib.parent == rqs_cuda.BUILD_DIR and lib.suffix == ".so"
    ignored = (Path(__file__).resolve().parents[1] / ".gitignore").read_text()
    assert "posteriflow_torch/_build/" in ignored.split()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", rqs_cuda.SUPPORTED_BINS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_kernel_matches_plain_on_card(cuda_device, k, inverse):
    """The kernel against the plain version on the card, through the
    wrapper on a sampling-shaped, non-contiguous x (the transform half of
    [B, n, D + 1]): out and logdet equal bit for bit, one launch."""
    xw, raw = _inputs(k, shape=(4, 250, 8), seed=k)
    x = torch.from_numpy(xw).to(cuda_device)[..., 1:]
    raw = torch.from_numpy(raw[..., 1:, :].copy()).to(cuda_device)
    assert not x.is_contiguous()
    before = rqs_cuda.KERNEL.launches
    w_fn = rqs_cuda.rqs_inverse if inverse else rqs_cuda.rqs_forward
    ko, kl = w_fn(x, raw, k)
    po, pl_ = _torch_fn(inverse)(x, raw, k)
    torch.cuda.synchronize()
    assert rqs_cuda.KERNEL.launches == before + 1
    assert ko.shape == x.shape and kl.shape == x.shape[:-1]
    assert float((ko - po).abs().max()) == 0.0
    assert float((kl - pl_).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["raw", "bias"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [1, 3, 641, 5000, 131072])
@pytest.mark.parametrize("d", [5, 7])
@pytest.mark.parametrize("k", rqs_cuda.SUPPORTED_BINS)
def test_kernel_tiles_match_plain_on_card(cuda_device, k, d, n, inverse,
                                          bias):
    """Every tile plan the flagship and the 11-D releases meet: full tiles,
    a ragged last tile and N below one tile, |x| up to 6 (tails beyond
    ±5), with and without the fused bias; out and logdet max |Δ| = 0
    against the plain version on raw + bias."""
    g = torch.Generator(device=cuda_device).manual_seed(1000 * k + n + d)
    r = 3 * k - 1
    x = (torch.randn(n, d, generator=g, device=cuda_device) * 2.5).clamp(
        -6.0, 6.0)
    raw = torch.randn(n, d, r, generator=g, device=cuda_device) * 0.7
    b = (torch.randn(r, generator=g, device=cuda_device) * 0.5
         if bias else None)
    ko, kl = rqs_cuda.KERNEL.launch(x, raw.reshape(n, -1), k, 5.0, inverse,
                                    bias=b)
    po, pl_ = _torch_fn(inverse)(x, raw if b is None else raw + b, k)
    torch.cuda.synchronize()
    assert float((ko - po).abs().max()) == 0.0
    assert float((kl - pl_).abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_card(cuda_device):
    x, raw = (torch.from_numpy(a).to(cuda_device) for a in _inputs(16))
    raw2 = raw.reshape(x.shape[0], -1)
    with pytest.raises(TypeError):
        rqs_cuda.KERNEL.launch(x.double(), raw2, 16, 5.0, False)
    with pytest.raises(ValueError):
        rqs_cuda.KERNEL.launch(x, raw2[:, 1:], 16, 5.0, False)
    with pytest.raises(ValueError):
        rqs_cuda.KERNEL.launch(x, raw.reshape(x.shape[0], -1), 10, 5.0,
                               False)
    with pytest.raises(ValueError):          # bias of the wrong length
        rqs_cuda.KERNEL.launch(x, raw2, 16, 5.0, False,
                               bias=torch.zeros(46, device=cuda_device))


@pytest.mark.cuda
def test_kernel_refuses_misaligned_raw_on_card(cuda_device):
    """raw and x are read by 16-B bulk copies: a view 4 B into its storage
    is refused, not copied; the wrapper copies a misaligned x (N·D floats)
    and gives the plain version's bits."""
    k, n, d = 16, 8, 5
    x = torch.zeros(n, d, device=cuda_device)
    storage = torch.zeros(n * d * (3 * k - 1) + 1, device=cuda_device)
    raw = storage[1:].view(n, -1)
    assert raw.is_contiguous() and raw.data_ptr() % 16 == 4
    before = rqs_cuda.KERNEL.launches
    with pytest.raises(ValueError, match="aligned"):
        rqs_cuda.KERNEL.launch(x, raw, k, 5.0, False)
    xs = torch.linspace(-6, 6, n * d + 1, device=cuda_device)[1:].view(n, d)
    assert xs.data_ptr() % 16 == 4
    raw_ok = torch.randn(n, d * (3 * k - 1), device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        rqs_cuda.KERNEL.launch(xs, raw_ok, k, 5.0, False)
    assert rqs_cuda.KERNEL.launches == before
    ko, kl = rqs_cuda.rqs_forward(xs, raw_ok.view(n, d, -1), k)
    po, pl_ = trqs.rqs_forward(xs, raw_ok.view(n, d, -1), k)
    assert torch.equal(ko, po) and torch.equal(kl, pl_)


@pytest.mark.cuda
def test_kernel_counts_one_per_launch_on_card(cuda_device):
    x, raw = (torch.from_numpy(a).to(cuda_device) for a in _inputs(8))
    raw2 = raw.reshape(x.shape[0], -1)
    before = rqs_cuda.KERNEL.launches
    for i in range(3):
        rqs_cuda.KERNEL.launch(x, raw2, 8, 5.0, bool(i % 2))
        assert rqs_cuda.KERNEL.launches == before + i + 1
    rqs_cuda.rqs_forward(x, raw, 8, bias=torch.zeros(23, device=cuda_device))
    assert rqs_cuda.KERNEL.launches == before + 4


def test_kernel_source_is_plain_c():
    """The kernel source includes no PyTorch or pybind header and exports
    the C launcher the wrapper binds."""
    src = rqs_cuda.SOURCE.read_text()
    assert 'extern "C" int pf_rqs_launch(' in src
    for banned in ("torch/extension.h", "pybind11", "ATen/"):
        assert banned not in src
    assert os.path.basename(rqs_cuda.SOURCE) == "rqs.cu"
