"""The port's native crop server and host feed on the CPU: the server
built from csrc/bankd.cpp into posteriflow_torch/_build/ gives crops and
segment choices bit-equal to the JAX package's server on the same bank
directory and seed (the JAX server bound to its own runtime/bankd.cpp,
compiled here into a temporary directory); the numpy path keeps its
contract; a failed build logs the compiler's output; HostNoiseFeed is
deterministic in (seed, batch index), equal to JAX's feed, and feeds
simulate_batch.

Every comparison here is exact: the crops are float16 samples converted
to float32 by the same code.
"""

import logging
import subprocess
import sys

import numpy as np
import pytest
import torch

import posteriflow_tpu.data.native_bank as jnb
import posteriflow_torch.data.native_bank as tnb
from posteriflow_tpu.data.host_feed import HostNoiseFeed as JFeed
from posteriflow_torch.data.host_feed import HostNoiseFeed
from posteriflow_torch.data.noise_bank import bank_filters, save_bank_segment
from posteriflow_torch.physics import simulator as tsim
from posteriflow_torch.physics.constants import N_RFFT, N_SAMPLES
from torch_sim_helpers import one_torch_thread

ROOT = tnb.SOURCE.parents[2]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(0)
    for det in ("H1", "L1", "V1"):
        for gps in (1262000000, 1262004096, 1262008192):
            save_bank_segment(d, det, gps, rng.standard_normal(2 * N_SAMPLES),
                              4e-24 * np.exp(rng.normal(0, 0.3, N_RFFT)))
    return d


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's runtime/bankd.cpp built as its Makefile builds it,
    into a temporary directory (runtime/ is left as it is)."""
    so = tmp_path_factory.mktemp("jaxlib") / "libpfbank.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-pthread",
                    "-shared", "-o", str(so),
                    str(ROOT / "runtime" / "bankd.cpp")], check=True)
    return so


@pytest.fixture
def jax_server(jax_lib, monkeypatch):
    monkeypatch.setattr(jnb, "_LIB_PATH", jax_lib)
    return jnb.NativeBankServer


def test_server_builds_into_build_dir(bank_dir):
    assert tnb.build_native()
    so = tnb.library_path()
    assert so.exists() and so.parent == ROOT / "posteriflow_torch" / "_build"
    srv = tnb.NativeBankServer(bank_dir)
    assert srv.native and srv.n_segments(0) == 3
    srv.close()


@pytest.mark.parametrize("n_threads", [1, 4])
def test_server_bit_equal_to_jax(bank_dir, jax_server, n_threads):
    t = tnb.NativeBankServer(bank_dir, n_threads=n_threads)
    j = jax_server(bank_dir, n_threads=n_threads)
    assert t.native and j.native
    for seed in (0, 7, 2 ** 40 + 3):
        tc, ti = t.sample(seed=seed, n_events=9)
        jc, ji = j.sample(seed=seed, n_events=9)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ti, ji)
    # into caller buffers, as the feed uses it
    out = np.empty((9, 3, 256), np.float32)
    idx = np.empty((9, 3), np.int32)
    t.sample(seed=5, n_events=9, crop_len=256, out=out, idx=idx)
    jc, ji = j.sample(seed=5, n_events=9, crop_len=256)
    np.testing.assert_array_equal(out, jc)
    np.testing.assert_array_equal(idx, ji)
    with pytest.raises(ValueError, match="C-contiguous"):
        t.sample(seed=5, n_events=9, out=np.empty((9, 3, 10), np.float32))
    t.close()
    j.close()


def test_numpy_path_keeps_its_contract(bank_dir, monkeypatch):
    monkeypatch.setattr(tnb, "_load_lib", lambda: None)
    srv = tnb.NativeBankServer(bank_dir)
    assert not srv.native and srv.n_segments(2) == 3
    crops, idx = srv.sample(seed=1, n_events=4)
    assert crops.shape == (4, 3, N_SAMPLES) and idx.shape == (4, 3)
    assert 0.9 < crops.std() < 1.1
    again, idx2 = srv.sample(seed=1, n_events=4)
    np.testing.assert_array_equal(crops, again)
    np.testing.assert_array_equal(idx, idx2)
    # each crop is a slice of its segment, possibly flipped and negated
    segs = [np.load(f).astype(np.float32) for f, _, _ in
            bank_filters(bank_dir, "L1")]
    c, seg = crops[0, 1], segs[idx[0, 1]]
    found = any(np.array_equal(seg[o:o + N_SAMPLES], cand)
                for cand in (c, -c[::-1])
                for o in np.flatnonzero(seg == cand[0]))
    assert found


def test_failed_build_logs_the_compiler_output(tmp_path, monkeypatch,
                                               caplog, bank_dir):
    bad = tmp_path / "bankd.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tnb, "SOURCE", bad)
    monkeypatch.setattr(tnb, "BUILD_DIR", tmp_path / "_build")
    with caplog.at_level(logging.WARNING, logger="posteriflow.data"):
        assert not tnb.build_native()
        srv = tnb.NativeBankServer(bank_dir)
    assert not srv.native
    assert "bank server build failed" in caplog.text
    assert "error" in caplog.text and "bankd.cpp" in caplog.text
    assert not list((tmp_path / "_build").glob("*.so"))


def _batches(feed, n):
    return [[t.clone() for t in feed.next()] for _ in range(n)]


def test_host_feed_deterministic_and_equal_to_jax(bank_dir, jax_server):
    """Batch i is the server's crops at seed·1_000_003 + i with the
    segments' filters and bands; the same (seed, i) gives the same batch,
    and JAX's feed gives it too."""
    with HostNoiseFeed(bank_dir, batch_size=3, seed=2, depth=1,
                       device="cpu") as feed:
        first = _batches(feed, 3)
    with HostNoiseFeed(bank_dir, batch_size=3, seed=2, device="cpu") as f2:
        second = _batches(f2, 2)
    with HostNoiseFeed(bank_dir, batch_size=3, seed=3, device="cpu") as f3:
        other = f3.next()
    for a, b in zip(first[:2], second):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert not torch.equal(first[0][0], other[0])
    srv = tnb.NativeBankServer(bank_dir)
    filt = [bank_filters(bank_dir, d) for d in ("H1", "L1", "V1")]
    for i, (noise, recolor, bands) in enumerate(first):
        crops, idx = srv.sample(seed=2 * 1_000_003 + i, n_events=3)
        np.testing.assert_array_equal(noise.numpy(), crops)
        for e in range(3):
            for d in range(3):
                np.testing.assert_array_equal(recolor[e, d].numpy(),
                                              filt[d][idx[e, d]][1])
                np.testing.assert_array_equal(bands[e, d].numpy(),
                                              filt[d][idx[e, d]][2])
    srv.close()
    with JFeed(bank_dir, batch_size=3, seed=2) as jf:
        for mine in first[:2]:
            for x, y in zip(mine, jf.next()):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_host_feed_under_thread_switching(bank_dir):
    """A short switch interval and a queue of depth 1: every batch is still
    the one its index names (a reused staging buffer would break it)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = tnb.NativeBankServer(bank_dir)
        with HostNoiseFeed(bank_dir, batch_size=2, seed=4, depth=1,
                           device="cpu") as feed:
            for i in range(8):
                noise, _, _ = feed.next()
                want, _ = srv.sample(seed=4 * 1_000_003 + i, n_events=2)
                np.testing.assert_array_equal(noise.numpy(), want)
        assert not feed._thread.is_alive()
        srv.close()
    finally:
        sys.setswitchinterval(old)


def test_feed_to_simulate_batch(bank_dir):
    """HostNoiseFeed -> simulate_batch(real_feed=) at real_noise_prob 1:
    finite whitened strain, the feed's bands on kept detectors."""
    cfg = tsim.SimConfig(prior=tsim.PriorConfig(max_signals=2),
                         real_noise_prob=1.0, det_dropout=0.5)
    with HostNoiseFeed(bank_dir, batch_size=4, seed=1,
                       device="cpu") as feed:
        noise, recolor, bands = feed.next()
    b = tsim.simulate_batch(4, cfg, device="cpu", real_feed=(noise, recolor,
                                                             bands),
                            generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(b.strain).all())
    std = b.strain.std(dim=(-2, -1))
    assert bool(((std > 0.8) & (std < 2.5)).all())
    torch.testing.assert_close(b.asd_bands, bands * b.det_mask[..., None],
                               rtol=0, atol=0)
