"""The port's noise bank against the JAX package's on the CPU: the bank
format written and read by both, the synthetic bank's filters from JAX's
own draws, the crops of JAX's sample_real_noise keys (rebuilt into the
port's RealNoiseDraws by tests/torch_sim_helpers.py), re-colouring, and the
draws' ranges.

Tolerances: file bytes, loaded segments, filters and band summaries, and
crops are exact (the same numpy arithmetic, and a crop is a copy of
float16 samples). The synthetic filter exp(interp(knots)) within 1e-6 (the
interpolation grid and exp in float32, rounded apart); its band summaries
within 1e-6. recolor_signal within 1e-5 of the signal's peak (float32
FFTs in two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.data import noise_bank as J
from posteriflow_torch.data import noise_bank as T
from posteriflow_torch.physics.constants import N_RFFT, N_SAMPLES
from torch_sim_helpers import jax_crop_draws, one_torch_thread

GPS = (1262000000, 1262004096, 1262008192)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _write(save, d, lengths=(4 * N_SAMPLES,) * 3, skip_asd=None):
    rng = np.random.default_rng(0)
    for det in ("H1", "L1", "V1"):
        for gps, n in zip(GPS, lengths):
            save(d, det, gps, rng.standard_normal(n),
                 4e-24 * np.exp(rng.normal(0, 0.3, N_RFFT)))
    if skip_asd:
        (d / skip_asd).unlink()


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bank")
    # L1's second segment is shorter: every detector is cut to it
    _write(T.save_bank_segment, d)
    rng = np.random.default_rng(1)
    T.save_bank_segment(d, "L1", GPS[1], rng.standard_normal(
        3 * N_SAMPLES + 5), 4e-24 * np.ones(N_RFFT))
    return d


def test_bank_files_equal_jax(tmp_path):
    """save_bank_segment writes the same bytes in both packages."""
    _write(T.save_bank_segment, tmp_path / "t")
    _write(J.save_bank_segment, tmp_path / "j")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 3 * 3 * 2 + 3
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


@pytest.mark.parametrize("max_segments", [None, 2])
def test_load_noise_bank_equals_jax(bank_dir, max_segments):
    jb = J.load_noise_bank(bank_dir, psd_bands=16, max_segments=max_segments)
    tb = T.load_noise_bank(bank_dir, psd_bands=16, max_segments=max_segments,
                           device="cpu")
    assert tb.segments.dtype == torch.float16
    assert tb.recolor.dtype == tb.asd_bands.dtype == torch.float32
    assert tb.n_segments == jb.n_segments == (max_segments or 3)
    assert tb.segment_len == jb.segment_len == 3 * N_SAMPLES + 5
    for name in ("segments", "recolor", "asd_bands"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)


def test_load_skips_a_segment_without_its_asd(tmp_path):
    _write(T.save_bank_segment, tmp_path, skip_asd=f"V1_{GPS[0]}_asd.npy")
    jb = J.load_noise_bank(tmp_path)
    tb = T.load_noise_bank(tmp_path, device="cpu")
    assert tb.n_segments == jb.n_segments == 2
    np.testing.assert_array_equal(tb.recolor.numpy(), np.asarray(jb.recolor))
    empty = tmp_path / "empty"
    empty.mkdir()
    for det in ("H1", "L1", "V1"):
        np.save(empty / f"design_asd_{det}.npy", np.ones(N_RFFT))
    with pytest.raises(ValueError, match="no segments for H1"):
        T.load_noise_bank(empty, device="cpu")


def test_synthetic_bank_from_jax_draws():
    """make_synthetic_bank's deterministic part, given JAX's segments and
    knots, gives JAX's bank."""
    key = jax.random.PRNGKey(4)
    n_seg, length = 2, N_SAMPLES + 64
    jb = J.make_synthetic_bank(key, n_segments=n_seg, segment_len=length)
    k1, k2 = jax.random.split(key)
    segs = np.array(jax.random.normal(k1, (3, n_seg, length))
                    .astype(jnp.float16))
    knots = np.array(0.3 * jax.random.normal(k2, (3, n_seg, T.N_KNOTS)))
    tb = T.synthetic_bank_from_draws(torch.from_numpy(segs),
                                     torch.from_numpy(knots))
    np.testing.assert_array_equal(tb.segments.numpy(),
                                  np.asarray(jb.segments))
    np.testing.assert_allclose(tb.recolor.numpy(), np.asarray(jb.recolor),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.asd_bands.numpy(),
                               np.asarray(jb.asd_bands), rtol=0, atol=1e-6)
    assert float(tb.recolor.min()) >= 1 / T.RECOLOR_CLAMP
    # the composed entry: shapes, dtypes, non-trivial filters
    g = torch.Generator().manual_seed(0)
    bank = T.make_synthetic_bank(g, n_segments=3, segment_len=length,
                                 device="cpu")
    assert bank.segments.shape == (3, 3, length)
    assert bank.segments.dtype == torch.float16
    assert bank.recolor.shape == (3, 3, N_RFFT)
    assert float(bank.asd_bands.abs().max()) > 1e-3


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(2)
    xp = np.sort(rng.uniform(0, 1, 8)).astype(np.float32)
    fp = rng.normal(0, 1, (2, 8)).astype(np.float32)
    x = np.concatenate([[-0.5, 1.5], xp, rng.uniform(-0.2, 1.2, 50)]
                       ).astype(np.float32)
    want = np.stack([np.asarray(jnp.interp(x, xp, f)) for f in fp])
    got = T.interp(torch.from_numpy(x), torch.from_numpy(xp),
                   torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_crops_equal_jax(bank_dir):
    """JAX's sample_real_noise keys, rebuilt into the port's draws, give
    the same crops, filters and bands, bit for bit; the port gathers a
    whole batch of them at once."""
    jb = J.load_noise_bank(bank_dir)
    tb = T.load_noise_bank(bank_dir, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    draws = [jax_crop_draws(k, tb.n_segments, tb.segment_len) for k in keys]
    batch = T.RealNoiseDraws(*[torch.stack(f) for f in zip(*draws)])
    assert batch.flip.any() and not batch.flip.all()
    got = T.real_noise_from_draws(tb, batch)
    for i, k in enumerate(keys):
        want = J.sample_real_noise(k, jb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got[0].dtype == torch.float32
    assert got[0].shape == (6, 3, N_SAMPLES)


def test_recolor_signal_matches_jax():
    rng = np.random.default_rng(3)
    sig = rng.standard_normal((2, 3, N_SAMPLES)).astype(np.float32)
    filt = np.exp(rng.normal(0, 0.3, (2, 3, N_RFFT))).astype(np.float32)
    want = np.asarray(J.recolor_signal(jnp.asarray(sig), jnp.asarray(filt)))
    got = T.recolor_signal(torch.from_numpy(sig),
                           torch.from_numpy(filt)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    ident = T.recolor_signal(torch.from_numpy(sig),
                             torch.ones(2, 3, N_RFFT)).numpy()
    np.testing.assert_allclose(ident, sig, atol=1e-5)


def test_draw_ranges():
    """seg_idx in [0, n_seg), offsets in [0, L - N_SAMPLES) (the upper end
    excluded, as in JAX), both flips."""
    g = torch.Generator().manual_seed(0)
    bank = T.NoiseBank(segments=torch.zeros(3, 2, N_SAMPLES + 3,
                                            dtype=torch.float16),
                       recolor=torch.ones(3, 2, N_RFFT),
                       asd_bands=torch.zeros(3, 2, 16))
    d = T.draw_real_noise((400,), bank, g)
    assert d.seg_idx.shape == d.off.shape == d.flip.shape == (400, 3)
    assert set(d.seg_idx.unique().tolist()) == {0, 1}
    assert set(d.off.unique().tolist()) == {0, 1, 2}
    assert 0.4 < float(d.flip.float().mean()) < 0.6
    one = T.sample_real_noise(bank, g)
    assert one[0].shape == (3, N_SAMPLES) and one[2].shape == (3, 16)
