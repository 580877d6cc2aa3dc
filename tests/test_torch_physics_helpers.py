"""The port's physics helpers against the JAX package on the CPU:
physics/cosmology.py whole, the matched-filter SNRs, the whitened network
SNR and coloured noise of physics/whiten.py, and load_network_asd /
asd_from_psd of physics/psd.py.

Bars: distances within 1e-5 relative; the redshift from the bisection
within 1e-5 absolute (one step of the 20 on [0, 10] is 10/2²⁰ ≈ 9.5e-6);
the SNRs within 1e-5 relative; coloured noise on JAX's own normals within
1e-5 of its peak; the ASDs bit-equal (both are numpy float64 cast to
float32 once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics import cosmology as JC
from posteriflow_tpu.physics import psd as JP
from posteriflow_tpu.physics import whiten as JWH
from posteriflow_tpu.physics.constants import FREQS, N_RFFT, N_SAMPLES
from posteriflow_tpu.physics.waveforms.taylorf2 import \
    taylorf2_polarizations as jtf2
from posteriflow_torch.physics import cosmology as TC
from posteriflow_torch.physics import psd as TP
from posteriflow_torch.physics import whiten as TWH
from torch_sim_helpers import one_torch_thread  # noqa: F401

REL = 1e-5
Z = np.array([0.0, 1e-3, 0.05, 0.1, 0.3, 0.7, 1.0, 2.5, 6.0], np.float32)
D_L = np.array([10.0, 40.0, 440.0, 476.0, 1000.0, 2100.0, 8000.0, 40000.0],
               np.float32)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


@pytest.mark.parametrize("fn", ["comoving_distance", "luminosity_distance"])
def test_distances_match_jax(fn):
    got = getattr(TC, fn)(torch.from_numpy(Z)).numpy()
    ref = np.asarray(getattr(JC, fn)(jnp.asarray(Z)))
    assert got.dtype == np.float32
    assert _rel(got[1:], ref[1:]) < REL
    assert got[0] == ref[0] == 0.0


def test_redshift_bisection_matches_jax():
    got = TC.redshift_from_luminosity_distance(torch.from_numpy(D_L))
    ref = np.asarray(JC.redshift_from_luminosity_distance(jnp.asarray(D_L)))
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5
    m1, m2, z = TC.source_frame_masses(36.0, 29.0, torch.from_numpy(D_L))
    jm1, jm2, jz = JC.source_frame_masses(36.0, 29.0, jnp.asarray(D_L))
    assert np.max(np.abs(z.numpy() - np.asarray(jz))) <= 1e-5
    assert _rel(m1.numpy(), np.asarray(jm1)) < 2e-5
    assert _rel(m2.numpy(), np.asarray(jm2)) < 2e-5


def test_cosmology_cases_of_the_jax_tests():
    """tests/test_augmentations.py:68-77, on the port."""
    d = float(TC.luminosity_distance(0.1))
    assert d == pytest.approx(476.0, rel=0.02)
    assert float(TC.redshift_from_luminosity_distance(d)) == pytest.approx(
        0.1, abs=1e-3)
    m1s, m2s, _ = TC.source_frame_masses(36.0, 29.0, 440.0)
    assert float(m1s) < 36.0 and float(m2s) < 29.0
    assert float(TC.chi_eff(30.0, 20.0, 0.5, -0.2)) == pytest.approx(0.22)
    assert float(TC.chirp_mass(30.0, 30.0)) == pytest.approx(26.12,
                                                             rel=1e-3)
    assert float(TC.mass_ratio(30.0, 15.0)) == pytest.approx(0.5)
    assert (TC.H0_KM_S_MPC, TC.OMEGA_M) == (JC.H0_KM_S_MPC, JC.OMEGA_M)
    rng = np.random.default_rng(0)
    m = rng.uniform(1.0, 90.0, (2, 16)).astype(np.float32)
    a = rng.uniform(-1.0, 1.0, (2, 16)).astype(np.float32)
    for name, args in (("chi_eff", (m[0], m[1], a[0], a[1])),
                       ("chirp_mass", (m[0], m[1])),
                       ("mass_ratio", (m[0], m[1]))):
        got = getattr(TC, name)(*[torch.from_numpy(x) for x in args])
        ref = getattr(JC, name)(*[jnp.asarray(x) for x in args])
        assert _rel(got.numpy(), np.asarray(ref)) < REL, name


def _design_asd():
    return (JP.asd_from_psd(JP.aligo_psd(FREQS)),
            TP.asd_from_psd(TP.aligo_psd(FREQS), device="cpu"))


def test_matched_filter_snrs_match_jax():
    jasd, tasd = _design_asd()
    f = jnp.asarray(FREQS, jnp.float32)
    hps = []
    for m1, m2, d in ((1.4, 1.4, 100.0), (1.4, 1.4, 400.0),
                      (36.0, 29.0, 400.0), (8.0, 1.4, 120.0)):
        hp, _ = jtf2(f, m1, m2, 0.1, 0.0, d, 0.3, 0.0)
        hps.append(np.asarray(hp))
    hp = np.stack(hps)
    ref = np.asarray(JWH.matched_filter_snr_fd(jnp.asarray(hp), jasd))
    got = TWH.matched_filter_snr_fd(torch.from_numpy(hp), tasd).numpy()
    assert _rel(got, ref) < REL
    for fl in (30.0, 60.0):
        assert _rel(TWH.matched_filter_snr_fd(torch.from_numpy(hp), tasd,
                                              fl).numpy(),
                    np.asarray(JWH.matched_filter_snr_fd(
                        jnp.asarray(hp), jasd, fl))) < REL
    td = np.fft.irfft(hp, n=N_SAMPLES).astype(np.float32) * 4096.0
    ref_td = np.asarray(JWH.matched_filter_snr_td(jnp.asarray(td), jasd))
    got_td = TWH.matched_filter_snr_td(torch.from_numpy(td), tasd).numpy()
    assert _rel(got_td, ref_td) < REL


def test_network_snr_whitened_matches_jax():
    rng = np.random.default_rng(1)
    sig = rng.normal(0, 0.05, (4, 3, 2048)).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 1], [1, 1, 0]],
                    np.float32)
    for m in (None, mask):
        ref = JWH.network_snr_whitened(
            jnp.asarray(sig), None if m is None else jnp.asarray(m))
        got = TWH.network_snr_whitened(
            torch.from_numpy(sig), None if m is None else torch.from_numpy(m))
        assert _rel(got.numpy(), np.asarray(ref)) < REL


def _jax_normals(key):
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.normal(kr, (N_RFFT,))),
            np.array(jax.random.normal(ki, (N_RFFT,))))


@pytest.mark.parametrize("seed", [0, 3])
def test_colored_noise_from_jax_normals(seed):
    """colored_noise_from_normals on the normals JAX's colored_noise_td
    draws from its key (split into kr, ki) reproduces JAX's series."""
    jasd, tasd = _design_asd()
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JWH.colored_noise_td(key, jasd))
    re, im = _jax_normals(key)
    got = TWH.colored_noise_from_normals(torch.from_numpy(re),
                                         torch.from_numpy(im), tasd).numpy()
    assert got.shape == ref.shape == (N_SAMPLES,)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))
    # a batch of two at once gives each row's own series
    re2, im2 = _jax_normals(jax.random.PRNGKey(seed + 100))
    both = TWH.colored_noise_from_normals(
        torch.from_numpy(np.stack([re, re2])),
        torch.from_numpy(np.stack([im, im2])), tasd).numpy()
    np.testing.assert_array_equal(both[0], got)


def test_colored_noise_draws_whiten_to_unit_variance():
    """The generator path: draws from a torch.Generator, whitened by the
    same ASD, have unit variance (the physics check JAX's CLI runs)."""
    _, tasd = _design_asd()
    g = torch.Generator().manual_seed(0)
    noise = TWH.colored_noise_td(tasd, generator=g, batch_shape=(8,))
    assert noise.shape == (8, N_SAMPLES)
    std = float(TWH.whiten_td(noise, tasd).std())
    assert 0.95 < std < 1.05
    again = TWH.colored_noise_td(tasd, generator=torch.Generator()
                                 .manual_seed(0), batch_shape=(8,))
    assert torch.equal(noise, again)


def test_asd_loaders_bit_equal(tmp_path):
    """load_network_asd (a dict with the design fallback, a sequence, the
    committed banks/asd_examples) and asd_from_psd: bit-equal to JAX."""
    f = np.geomspace(12.0, 2048.0, 400)
    asd = 1e-23 * (f / 100.0) ** -0.5 + 3e-24
    path = tmp_path / "H1_asd.txt"
    np.savetxt(path, np.c_[f, asd], header="f asd")
    p2 = tmp_path / "L1_psd.txt"
    np.savetxt(p2, np.c_[f, asd ** 2])
    examples = {d: f"banks/asd_examples/{d}_synth64_median_asd.txt"
                for d in ("H1", "L1", "V1")}
    for paths in ({"H1": path}, {"L1": p2, "V1": path}, [path, p2, path],
                  examples):
        got = TP.load_network_asd(paths, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (3, N_RFFT)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JP.load_network_asd(paths)))
    for psd in (JP.default_network_psd(), JP.aligo_psd(FREQS),
                np.zeros(8), np.full(8, 1e-46)):
        np.testing.assert_array_equal(
            TP.asd_from_psd(psd, device="cpu").numpy(),
            np.asarray(JP.asd_from_psd(psd)))
