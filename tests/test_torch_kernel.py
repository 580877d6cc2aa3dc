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
    [B, n, D + 1]): 2e-5 on out, 2e-4 on logdet, one launch."""
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
    assert float((ko - po).abs().max()) <= 2e-5
    assert float((kl - pl_).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_card(cuda_device):
    x, raw = (torch.from_numpy(a).to(cuda_device) for a in _inputs(16))
    raw2 = raw.reshape(x.shape[0], -1)
    with pytest.raises(TypeError):
        rqs_cuda.KERNEL.launch(x.double(), raw2, 16, 5.0, False)
    with pytest.raises(ValueError):
        rqs_cuda.KERNEL.launch(x, raw2[:, 1:], 16, 5.0, False)
    with pytest.raises(ValueError):
        rqs_cuda.KERNEL.launch(x, raw.reshape(x.shape[0], -1), 12, 5.0,
                               False)


def test_kernel_source_is_plain_c():
    """The kernel source includes no PyTorch or pybind header and exports
    the C launcher the wrapper binds."""
    src = rqs_cuda.SOURCE.read_text()
    assert 'extern "C" int pf_rqs_launch(' in src
    for banned in ("torch/extension.h", "pybind11", "ATen/"):
        assert banned not in src
    assert os.path.basename(rqs_cuda.SOURCE) == "rqs.cu"
