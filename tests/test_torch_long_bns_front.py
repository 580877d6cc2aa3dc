"""The long-BNS front ends of the port (posteriflow_torch/models/long_bns.py)
against the JAX package on the same numpy inputs: taylorf2_polarizations,
the v4 trigger grid (the port's builder, and the stored grid JAX built for
long_bns_v4), the heterodyne pooling, trigger_tokens and the v1 multiband
tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models import long_bns as jlb
from posteriflow_tpu.physics.waveforms.taylorf2 import \
    taylorf2_amp_phase as j_tf2
from posteriflow_tpu.physics.waveforms.taylorf2 import \
    taylorf2_polarizations as j_pol
from posteriflow_tpu.physics.waveforms.tidal import matter_effects as j_me
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.physics.waveforms.taylorf2 import \
    taylorf2_polarizations as t_pol
from torch_long_bns_helpers import (TEST_TOKENS, jax_grid,
                                    release_tokens_cfg)
from torch_sim_helpers import match, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def release_grids():
    """(the port's stored grid, JAX's own build) for long_bns_v4."""
    tok = release_tokens_cfg()
    return (tlb.load_stored_grid(tok),
            jax_grid(**{k: v for k, v in tok.items() if k != "kind"}))


def _jgrid(grid: dict) -> dict:
    return {k: v for k, v in grid.items() if not k.startswith("_")}


@pytest.mark.parametrize("params", [
    (1.4, 1.3, 0.03, -0.02, 40.0, 0.4, 1.1),
    (2.5, 1.0, 0.05, 0.0, 250.0, 2.2, 5.0),
    (1.0, 1.0, -0.05, 0.05, 10.0, 1.3, 0.0)], ids=["bns", "q04", "equal"])
def test_taylorf2_polarizations(params):
    """h₊ and hₓ on the 64-s band to 1024 Hz (ISCO cut included for the
    heavy case): the match per polarization above 1 - 1e-5 and the norm
    within 1e-5 (float32 Ψ ~ 1e4 rad differs by a few steps between the
    packages), and zero above ISCO in both."""
    freqs = tlb.band_freqs(64.0, 1024.0).astype(np.float32)
    jp, jc = (np.asarray(a) for a in jax.jit(j_pol)(
        jnp.asarray(freqs), *params))
    tp, tc = (a.numpy() for a in t_pol(torch.from_numpy(freqs),
                                       *(torch.tensor(v) for v in params)))
    assert tp.dtype == np.complex64 and tp.shape == jp.shape
    for t, j in ((tp, jp), (tc, jc)):
        assert match(t, j) > 1 - 1e-5
        assert abs(np.linalg.norm(t) / np.linalg.norm(j) - 1.0) < 1e-5
        np.testing.assert_array_equal(t == 0, j == 0)


@pytest.mark.parametrize("which", ["test", "release"])
def test_grid_builder_against_jax(which, release_grids):
    """The port's builder at the JAX tests' config (16 s, f_hi 256, pad
    32) and at long_bns_v4's: n_tok, L, i_lo, cut and epoch_cyc equal to
    JAX's; the segment boundaries follow the float32 phase's last bits, so
    some move (measured: 109 of 140 by up to 17 bins at the test config,
    81 of 168 by up to 5 at the release's); held to those counts."""
    if which == "test":
        j = jax_grid(**TEST_TOKENS)
        t = tlb.build_trigger_token_grid(**TEST_TOKENS)
        most_moved, largest = 140, 24
    else:
        _, j = release_grids
        tok = release_tokens_cfg()
        t = tlb.build_trigger_token_grid(
            **{k: v for k, v in tok.items() if k != "kind"})
        most_moved, largest = 120, 8
    for k in ("n_tok", "L", "i_lo", "cut"):
        assert t[k] == j[k], k
    assert t["config"] == j["config"]
    np.testing.assert_array_equal(t["epoch_cyc"], j["epoch_cyc"])
    np.testing.assert_array_equal(t["freqs"], j["freqs"])
    n = t["n_tok"]
    moved = t["ends"][:n].astype(int) - j["ends"][:n].astype(int)
    assert (t["ends"][n - 1] == j["ends"][n - 1]
            == len(t["freqs"]) - t["i_lo"])
    assert np.count_nonzero(moved) <= most_moved
    assert np.abs(moved).max() <= largest
    assert (t["counts"][n:] == 1).all()
    assert (t["ends"][n:] == t["ends"][n - 1]).all()


def test_stored_grid_is_jax_grid(release_grids):
    """The stored grid of long_bns_v4's tokens config, named by its config
    hash, equals JAX's build bit for bit; a config with no stored grid
    raises rather than building one."""
    stored, j = release_grids
    tok = release_tokens_cfg()
    assert tlb.stored_grid_path(tok).name == "trigger_341114687ac7.npz"
    assert stored["config"] == j["config"] == tok
    for k in tlb.GRID_ARRAYS + ("freqs",):
        assert stored[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(stored[k], j[k], err_msg=k)
    for k in tlb.GRID_SCALARS:
        assert stored[k] == j[k] and type(stored[k]) is type(j[k]), k
    with pytest.raises(FileNotFoundError, match="no stored trigger grid"):
        tlb.load_stored_grid(dict(tok, alpha=1.5))


def _strain(rng, grid, scale=1.0):
    f = grid["cut"]
    return (scale * (rng.standard_normal((2, 3, f))
                     + 1j * rng.standard_normal((2, 3, f)))).astype(
                         np.complex64)


def test_pool_heterodyned(release_grids):
    """The cumsum + boundary-gather pooling on the same heterodyned strain:
    the coherent channels within 2e-5, the excess-energy channels within
    1e-3 (JAX's float32 cumulative |x|² reaches ~6e4, where a float32 step
    is 4e-3; the port sums in float64), features exact."""
    grid, _ = release_grids
    rng = np.random.default_rng(1)
    x = _strain(rng, grid)[..., grid["i_lo"]:]
    jt = np.asarray(jax.jit(jax.vmap(
        lambda a: jlb._pool_heterodyned(a, _jgrid(grid))))(x))
    tt = tlb.pool_heterodyned(torch.from_numpy(x), grid).numpy()
    assert tt.shape == jt.shape == (2, grid["L"], 11)
    np.testing.assert_allclose(tt[..., :6], jt[..., :6], atol=2e-5)
    np.testing.assert_allclose(tt[..., 6:9], jt[..., 6:9], atol=1e-3)
    np.testing.assert_array_equal(tt[..., 9:], jt[..., 9:])


def _jax_phase(grid, mc_hat):
    fb = jnp.asarray(grid["freqs"][grid["i_lo"]:], jnp.float32)

    def one(m):
        m = m / tlb.EQM
        return j_tf2(fb, m, m, 0.0, 0.0, 100.0, 0.0)[1] + j_me(fb, m, m)[0]
    return np.asarray(jax.jit(jax.vmap(one))(mc_hat))


def test_trigger_tokens(release_grids):
    """trigger_tokens on a loud chirp plus noise at two triggers: with
    JAX's Ψ(M̂c) given, the coherent channels within 1e-4 of the largest
    coherent token plus 2e-5 (cos and sin of the ~2e4-rad float32 phase
    round differently in the two packages: measured 4.8e-5 of it) and the
    energy channels within 1e-3 (the pooling's tolerance); the port's own
    float32 Ψ(M̂c) is within 0.02 rad of JAX's at ~2e4 rad (measured
    0.0156), and
    the coherent channels then differ by at most that phase times the
    largest coherent token plus 1e-4."""
    grid, _ = release_grids
    rng = np.random.default_rng(2)
    theta = np.array([[1.6, 1.3, 40.0, 2.0, 0.5, 2.1, 0.2, 4.0, -0.4, 0.03,
                       0.02],
                      [2.3, 1.1, 120.0, 4.5, -0.9, 1.2, 2.5, 0.5, 1.1,
                       0.04, 0.01]], np.float32)
    h_w = tlb.white_signal(torch.from_numpy(theta), grid["freqs"],
                           grid["duration"]).numpy()
    h = np.array(h_w + _strain(rng, grid), np.complex64)
    trig = np.array([[1.2606, 0.0512, 0.0551, 0.0463],
                     [1.3801, 1.1021, 1.0911, 1.1102]], np.float32)
    jpsi = np.array(_jax_phase(grid, trig[:, 0]))
    jt = np.asarray(jax.jit(jax.vmap(lambda a, tr: jlb.trigger_tokens(
        a, _jgrid(grid), tr[0], tr[1:])))(h, trig))
    args = (torch.from_numpy(h), grid, torch.from_numpy(trig[:, 0]),
            torch.from_numpy(trig[:, 1:]))
    tt = tlb.trigger_tokens(*args, psi=torch.from_numpy(jpsi)).numpy()
    peak = np.abs(jt[..., :6]).max()
    np.testing.assert_allclose(tt[..., :6], jt[..., :6],
                               atol=1e-4 * peak + 2e-5)
    np.testing.assert_allclose(tt[..., 6:], jt[..., 6:], atol=1e-3)
    tpsi = tlb.trigger_phase(grid, torch.from_numpy(trig[:, 0])).numpy()
    dpsi = float(np.abs(tpsi - jpsi).max())
    assert dpsi <= 0.02, dpsi
    own = tlb.trigger_tokens(*args).numpy()
    tol = dpsi * np.abs(jt[..., :6]).max() + 1e-4
    assert np.abs(own[..., :6] - jt[..., :6]).max() <= tol
    np.testing.assert_allclose(own[..., 6:], jt[..., 6:], atol=1e-3)


def test_multiband_tokens():
    """v1's multiband tokens (64 bands × 32 at 64 s to 1024 Hz, 2048
    tokens of 6 channels) on the same strain: within 1e-6 of the largest
    |token| (a float32 mean over up to ~120 bins, summed in another order)."""
    freqs = tlb.band_freqs(64.0, 1024.0)
    rng = np.random.default_rng(3)
    h = (rng.standard_normal((1, 3, freqs.size))
         + 1j * rng.standard_normal((1, 3, freqs.size))).astype(np.complex64)
    jt = np.asarray(jax.jit(lambda a: jlb.multiband_tokens(a, freqs))(h))
    tt = tlb.multiband_tokens(torch.from_numpy(h), freqs).numpy()
    assert tt.shape == jt.shape == (1, 2048, 6)
    np.testing.assert_allclose(tt, jt, atol=1e-6 * np.abs(jt).max())
