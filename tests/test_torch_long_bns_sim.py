"""The long-BNS simulators of the port, their draws and their labels, against
the JAX package: the v4 apply step against the body of JAX's
simulate_long_bns_batch_v4 (`one`) composed on the same θ, noise and
trigger errors, the v1 apply step likewise, TriggerScaler and
trigger_features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models import long_bns as jlb
from posteriflow_tpu.physics.projection import (GMST_REF, OMEGA_EARTH,
                                                network_response,
                                                project_to_network)
from posteriflow_tpu.physics.psd import default_network_psd
from posteriflow_tpu.physics.waveforms.taylorf2 import \
    taylorf2_polarizations
from posteriflow_tpu.physics.waveforms.tidal import matter_effects
from posteriflow_tpu.physics.whiten import whiten_fd
from posteriflow_torch.models import long_bns as tlb
from torch_long_bns_helpers import release_tokens_cfg
from torch_sim_helpers import match, one_torch_thread  # noqa: F401

# θ: m1, m2, d, ra, dec, theta_jn, psi, phase, t_off, a1, a2 (BNS prior)
THETA = np.array([[1.6, 1.3, 40.0, 2.0, 0.5, 2.1, 0.2, 4.0, -0.4, 0.03, 0.02],
                  [2.3, 1.1, 120.0, 4.5, -0.9, 1.2, 2.5, 0.5, 1.1, 0.04,
                   0.01],
                  [1.05, 1.02, 250.0, 0.3, 1.1, 0.9, 1.7, 3.3, 1.5, 0.0,
                   0.05]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def grid():
    return tlb.load_stored_grid(release_tokens_cfg())


def _jgrid(grid):
    return {k: v for k, v in grid.items() if not k.startswith("_")}


def _noise(rng, b, f):
    return np.array(rng.standard_normal((b, 3, f))
                    + 1j * rng.standard_normal((b, 3, f)), np.complex64)


def _jax_white(freqs_np, duration):
    """JAX's whitened signal and trigger of one event: the body of
    simulate_long_bns_batch_v4's `one` (long_bns.py:571-596) up to the
    noise."""
    freqs = jnp.asarray(freqs_np, jnp.float32)
    asd = jnp.asarray(np.sqrt(default_network_psd(freqs_np)) * 1e23,
                      jnp.float32)

    def white(th):
        (m1, m2, d, ra, dec, tj, psi_a, ph, t_off, a1, a2) = th
        hp, hc = taylorf2_polarizations(freqs, m1, m2, a1, a2, d, tj, ph)
        psi_t, taper = matter_effects(freqs, m1, m2)
        fac = (taper * jnp.exp(-1j * psi_t.astype(jnp.float32))
               ).astype(jnp.complex64)
        h_det = project_to_network(freqs, hp * fac, hc * fac, ra, dec,
                                   psi_a, t_off, duration=duration)
        return whiten_fd(h_det, asd, 1.0 / duration)
    return white


def _jax_v4(grid, theta, noise, eps, amp_scale):
    white = _jax_white(grid["freqs"], grid["duration"])
    jg = _jgrid(grid)

    def one(th, nz, ep):
        (m1, m2, d, ra, dec, tj, psi_a, ph, t_off, a1, a2) = th
        h_w = white(th)
        mc = (m1 * m2) ** 0.6 * (m1 + m2) ** -0.2
        _, _, dt = network_response(ra, dec, psi_a,
                                    GMST_REF + OMEGA_EARTH * t_off)
        mc_hat = mc * (1.0 + grid["sigma_mc_rel"] * ep[0])
        t_hat = t_off + dt + grid["sigma_t"] * ep[1:]
        tok = jlb.trigger_tokens(amp_scale * h_w + nz, jg, mc_hat, t_hat)
        return tok, h_w, jnp.concatenate([mc_hat[None], t_hat])
    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(theta, noise, eps)]


def test_v4_apply_step_against_jax(grid):
    """simulate_long_bns_v4_from_draws against JAX's `one` on the same θ,
    noise and ε, with the signal and without (amp_scale 0). The whitened
    signal per detector: match above 1 - 1e-4 and norm within 1e-4 (the
    float32 chirp phase reaches ~2e4 rad; the packages differ by a few of
    its steps). The trigger: M̂c within 2 float32 steps (the port rounds
    the chirp mass once from float64, JAX's float32 pow may be a step
    off), t̂ within 1e-6 s. The tokens: coherent channels within 2e-2 of
    the largest coherent token of the signal alone (measured 6.5e-3: the
    phase's steps), energy channels within 1e-3 of the largest energy
    token of the signal alone plus 1e-3; without the signal, the
    pooling's tolerance for the energy channels and, for the coherent
    ones, 2e-2 of their largest |token| (the heterodyne's Ψ(M̂c) differs
    by up to 0.02 rad, tests/test_torch_long_bns_front.py); θ exact."""
    rng = np.random.default_rng(0)
    noise = _noise(rng, len(THETA), grid["cut"])
    eps = np.clip(rng.standard_normal((len(THETA), 4)), -3.5,
                  3.5).astype(np.float32)
    draws = tlb.LongBNSDraws(torch.from_numpy(THETA),
                             torch.from_numpy(noise), torch.from_numpy(eps))
    jt, jh, jtrig = _jax_v4(grid, THETA, noise, eps, 1.0)
    tt, tth, ttrig = (a.numpy() for a in
                      tlb.simulate_long_bns_v4_from_draws(draws, grid))
    th = tlb.white_signal(draws.theta, grid["freqs"],
                          grid["duration"]).numpy()
    for b in range(len(THETA)):
        for d in range(3):
            assert match(th[b, d], jh[b, d]) > 1 - 1e-4
            assert abs(np.linalg.norm(th[b, d]) / np.linalg.norm(jh[b, d])
                       - 1.0) < 1e-4
    np.testing.assert_array_equal(tth, THETA)
    np.testing.assert_allclose(ttrig[:, 0], jtrig[:, 0], rtol=2.5e-7)
    np.testing.assert_allclose(ttrig[:, 1:], jtrig[:, 1:], atol=1e-6)
    j_sig = _jax_v4(grid, THETA, np.zeros_like(noise), eps, 1.0)[0]
    coh, energy = np.abs(j_sig[..., :6]).max(), np.abs(j_sig[..., 6:9]).max()
    assert np.abs(tt[..., :6] - jt[..., :6]).max() <= 2e-2 * coh
    assert np.abs(tt[..., 6:9] - jt[..., 6:9]).max() <= 1e-3 * energy + 1e-3
    np.testing.assert_array_equal(tt[..., 9:], jt[..., 9:])

    j0 = _jax_v4(grid, THETA, noise, eps, 0.0)[0]
    t0, th0, trig0 = (a.numpy() for a in
                      tlb.simulate_long_bns_v4_from_draws(draws, grid, 0.0))
    np.testing.assert_array_equal(th0, THETA)
    np.testing.assert_array_equal(trig0, ttrig)
    np.testing.assert_allclose(t0[..., :6], j0[..., :6],
                               atol=2e-2 * np.abs(j0[..., :6]).max())
    np.testing.assert_allclose(t0[..., 6:], j0[..., 6:], atol=1e-3)
    assert np.abs(t0 - tt).max() > 1e-2


def test_v1_apply_step_against_jax():
    """simulate_long_bns_from_draws (v1: 64 s to 1024 Hz, 64 bands × 32)
    against the body of JAX's simulate_long_bns_batch on the same θ and
    noise: within 2e-2 of the largest token of the signal alone plus 1e-5
    (the whitened signal's float32 phase differs by a few of its steps, as
    in the v4 test)."""
    freqs = tlb.band_freqs(64.0, 1024.0)
    rng = np.random.default_rng(1)
    noise = _noise(rng, 2, freqs.size)
    white = _jax_white(freqs, 64.0)
    j_fn = jax.jit(jax.vmap(lambda th, nz: jlb.multiband_tokens(
        white(th) + nz, freqs)))
    jt = np.asarray(j_fn(THETA[:2], noise))
    j_sig = np.abs(np.asarray(j_fn(THETA[:2], np.zeros_like(noise)))).max()
    draws = tlb.LongBNSDraws(torch.from_numpy(THETA[:2]),
                             torch.from_numpy(noise), None)
    tt, th = tlb.simulate_long_bns_from_draws(draws)
    np.testing.assert_array_equal(th.numpy(), THETA[:2])
    assert tt.shape == (2, 2048, 6)
    np.testing.assert_allclose(tt.numpy(), jt, atol=2e-2 * j_sig + 1e-5)


def test_draws(grid):
    """draw_long_bns: θ inside the BNS prior (m1 >= m2 in [1, 2.5],
    distance in [10, 300] Mpc), complex normal noise with E|n|² = 2, the
    trigger errors within ±trunc with unit spread; v1 draws no trigger;
    the same generator seed gives the same draws."""
    gen = torch.Generator().manual_seed(5)
    d = tlb.draw_long_bns(400, 1000, grid["trunc"], gen, "cpu")
    th = d.theta.numpy()
    assert th.shape == (400, 11) and d.noise.shape == (400, 3, 1000)
    assert (th[:, 0] >= th[:, 1]).all()
    assert th[:, :2].min() >= 1.0 and th[:, :2].max() <= 2.5
    assert th[:, 2].min() >= 10.0 and th[:, 2].max() <= 300.0
    e2 = float((d.noise.abs() ** 2).mean())
    assert abs(e2 - 2.0) < 0.02
    eps = d.eps.numpy()
    assert eps.shape == (400, 4) and np.abs(eps).max() <= grid["trunc"]
    assert abs(eps.std() - 1.0) < 0.06 and abs(eps.mean()) < 0.1
    assert tlb.draw_long_bns(2, 10, None, gen, "cpu").eps is None
    again = tlb.draw_long_bns(400, 1000, grid["trunc"],
                              torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))


def _trig(theta, rng, grid):
    """A trigger for θ: the truth moved by bounded errors."""
    eps = np.clip(rng.standard_normal((len(theta), 4)), -3.5, 3.5)
    return tlb.trigger_of(torch.from_numpy(theta),
                          torch.from_numpy(eps.astype(np.float32)),
                          grid).numpy()


def test_trigger_scaler_against_jax(grid):
    """TriggerScaler on the same θ and trigger: normalize within 1e-4 (y_mc
    divides the chirp mass by 2.5e-3, so one float32 step of it moves
    y_mc by ~1e-4), denormalize within 1e-5 relative."""
    rng = np.random.default_rng(3)
    theta = THETA
    trig = _trig(theta, rng, grid)
    js = jlb.TriggerScaler(grid["sigma_mc_rel"], grid["sigma_t"],
                           grid["trunc"], grid["q_min"])
    ts = tlb.TriggerScaler(grid["sigma_mc_rel"], grid["sigma_t"],
                           grid["trunc"], grid["q_min"])
    jy = np.asarray(jax.jit(js.normalize)(theta, trig))
    ty = ts.normalize(torch.from_numpy(theta), torch.from_numpy(trig))
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-4)
    y = np.clip(rng.standard_normal((3, 11)) * 0.5, -0.99,
                0.99).astype(np.float32)
    jth = np.asarray(jax.jit(js.denormalize)(y, trig))
    tth = ts.denormalize(torch.from_numpy(y), torch.from_numpy(trig))
    np.testing.assert_allclose(tth.numpy(), jth, rtol=1e-5, atol=1e-6)


def test_trigger_scaler_roundtrip_and_bounds(grid):
    """As tests/test_long_bns.py:351-367, on the port's own v4 batch: the
    labels are finite, y_mc, y_q and y_t lie strictly inside [-1, 1], and
    denormalize inverts normalize within 1e-4 absolute + 1e-5 relative."""
    gen = torch.Generator().manual_seed(0)
    _, theta, trig = tlb.simulate_long_bns_batch_v4(16, grid, generator=gen,
                                                    device="cpu")
    sc = tlb.TriggerScaler(grid["sigma_mc_rel"], grid["sigma_t"],
                           grid["trunc"], grid["q_min"])
    y = sc.normalize(theta, trig)
    assert torch.isfinite(y).all()
    for i in (0, 1, 8):
        assert float(y[:, i].abs().max()) < 1.0, i
    np.testing.assert_allclose(sc.denormalize(y, trig).numpy(),
                               theta.numpy(), atol=1e-4, rtol=1e-5)


def test_trigger_features_against_jax(grid):
    """trigger_features on the same trigger: within 1e-5 (the relative
    arrival pattern divides t̂ − mean t̂ by 0.02, so a float32 step of t̂
    at ~1 s, 1.2e-7, is 6e-6 there)."""
    trig = _trig(THETA, np.random.default_rng(4), grid)
    jf = np.asarray(jlb.trigger_features(jnp.asarray(trig), grid["mc_lo"],
                                         grid["mc_hi"]))
    tf = tlb.trigger_features(torch.from_numpy(trig), grid["mc_lo"],
                              grid["mc_hi"]).numpy()
    assert tf.shape == (3, 5)
    np.testing.assert_allclose(tf, jf, atol=1e-5)
