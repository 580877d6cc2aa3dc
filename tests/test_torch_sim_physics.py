"""The port's detector geometry, projection, whitening and design ASD
against the JAX package's, on random sky positions and spectra.

Tolerances: the geometry and the ASD are float32 products of float64
tables (atol 1e-6 on antenna patterns of size ≤ 1, 1e-9 s on delays of
≤ 21 ms, the ASD bit for bit); a projected or whitened series is held to
atol 1e-5 of its largest entry (float32 FFTs of 16384 points round at
~1e-6 of the peak)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics import detectors as jdet
from posteriflow_tpu.physics import projection as jproj
from posteriflow_tpu.physics import psd as jpsd
from posteriflow_tpu.physics import whiten as jwh
from posteriflow_torch.physics import detectors as tdet
from posteriflow_torch.physics import projection as tproj
from posteriflow_torch.physics import psd as tpsd
from posteriflow_torch.physics import whiten as twh
from posteriflow_torch.physics.constants import FREQS, N_RFFT, N_SAMPLES

F32 = np.asarray(FREQS, np.float32)


def _sky(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32) for lo, hi in
            ((0, 2 * np.pi), (-1.5, 1.5), (0, np.pi), (-1.5, 1.5))]


@jax.jit
def _jax_all(ra, dec, psi, t_off, hp, hc, strain, h_fd, asd):
    gmst = jproj.GMST_REF + jproj.OMEGA_EARTH * t_off
    resp = jax.vmap(jdet.network_response)(ra, dec, psi, gmst)
    proj = jax.vmap(lambda a, b, r, d, p, t: jproj.project_to_network(
        jnp.asarray(F32), a, b, r, d, p, t))(hp, hc, ra, dec, psi, t_off)
    return (resp, proj, jwh.whiten_td(strain, asd), jwh.whiten_fd(h_fd, asd),
            jwh.fd_white_to_td(h_fd))


@pytest.fixture(scope="module")
def both():
    ra, dec, psi, t_off = _sky(4)
    rng = np.random.default_rng(1)
    hp = (rng.standard_normal((4, N_RFFT))
          + 1j * rng.standard_normal((4, N_RFFT))).astype(np.complex64)
    hc = (rng.standard_normal((4, N_RFFT))
          + 1j * rng.standard_normal((4, N_RFFT))).astype(np.complex64)
    strain = rng.standard_normal((2, 3, N_SAMPLES)).astype(np.float32)
    h_fd = hp[:3][None].repeat(2, 0)
    asd_j = jpsd.default_network_asd()
    j = jax.tree_util.tree_map(np.asarray, _jax_all(
        ra, dec, psi, t_off, hp, hc, strain, h_fd, asd_j))
    T = torch.from_numpy
    asd_t = tpsd.default_network_asd(device="cpu")
    gmst = tproj.GMST_REF + tproj.OMEGA_EARTH * T(t_off)
    t = (tdet.network_response(T(ra), T(dec), T(psi), gmst),
         tproj.project_to_network(T(F32), T(hp), T(hc), T(ra), T(dec),
                                  T(psi), T(t_off)),
         twh.whiten_td(T(strain), asd_t), twh.whiten_fd(T(h_fd), asd_t),
         twh.fd_white_to_td(T(h_fd)))
    return j, jax.tree_util.tree_map(lambda a: a.numpy(), t), asd_j, asd_t


def test_design_asd_is_bit_equal(both):
    _, _, asd_j, asd_t = both
    assert asd_t.dtype == torch.float32 and asd_t.shape == (3, N_RFFT)
    np.testing.assert_array_equal(asd_t.numpy(), np.asarray(asd_j))


def test_gmst_and_geometry_are_the_same_numbers():
    assert tproj.GMST_REF == jproj.GMST_REF
    assert tdet.gmst_from_gps(1.2e9) == jdet.gmst_from_gps(1.2e9)
    np.testing.assert_array_equal(tdet.RESPONSE_TENSORS,
                                  jdet.RESPONSE_TENSORS)
    np.testing.assert_array_equal(tdet.VERTICES, jdet.VERTICES)


@pytest.mark.parametrize("what,atol", [(0, 1e-6), (1, 1e-6), (2, 1e-9)],
                         ids=["f_plus", "f_cross", "delay"])
def test_network_response(both, what, atol):
    j, t, _, _ = both
    np.testing.assert_allclose(t[0][what], j[0][what], atol=atol)


def test_antenna_pattern_per_detector():
    ra, dec, psi, t_off = (torch.from_numpy(a) for a in _sky(8, seed=3))
    fp, fc, _ = tdet.network_response(ra, dec, psi, t_off)
    for i in range(3):
        p, c = tdet.antenna_pattern(i, ra, dec, psi, t_off)
        assert torch.equal(p, fp[:, i]) and torch.equal(c, fc[:, i])


@pytest.mark.parametrize("idx", [1, 2, 3, 4],
                         ids=["project", "whiten_td", "whiten_fd",
                              "fd_white_to_td"])
def test_series(both, idx):
    j, t, _, _ = both
    assert t[idx].shape == j[idx].shape
    np.testing.assert_allclose(t[idx], j[idx],
                               atol=1e-5 * np.abs(j[idx]).max())


def test_edge_bins_read_as_real():
    """fd_white_to_td zeroes the imaginary parts of the DC and Nyquist bins,
    which a C2R transform of a real series does not read: the result is
    the same as pocketfft's on the untouched input."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy((rng.standard_normal((3, N_RFFT)) + 1j
                          * rng.standard_normal((3, N_RFFT)))
                         .astype(np.complex64))
    raw = torch.fft.irfft(h * np.sqrt(N_SAMPLES / 2.0), n=N_SAMPLES)
    assert torch.equal(twh.fd_white_to_td(h), raw)
