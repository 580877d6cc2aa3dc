"""The port's polarization entry points and approximant registry against
the JAX package on the CPU (physics/waveforms/): phenomd_polarizations,
phenomd_matter_polarizations (= imr_polarizations), phenomp_polarizations,
imr_stitch_polarizations, TaylorF2, APPROXIMANTS, and
precessing_signal_white_fd.

The port takes N signals as [N, 1] columns; JAX's functions take one
signal and are vmapped here. Bars: |h₊| and |hₓ| are free of phase
rounding and held within 1e-5 of their peak. The complex values carry
the float32 rounding of Ψ: within 2e-3 of the peak (the bar of
tests/test_torch_sim_event.py:6-13) where the largest in-band |Ψ| is
small, and within 16 float32 steps of the largest |Ψ| where it is large.
Measured: a BNS (1.6 + 1.3 Msun) reaches |Ψ| = 11,473 rad at 20 Hz, whose
float32 step is 9.8e-4 rad, and the two packages' Ψ differ there by up to
9 steps (8.8e-3 rad, 6.4e-3 of the peak in the complex value); an NSBH
(8 + 1.4) 3,255 rad, 9 steps of 2.4e-4; a BBH (36 + 29) 233 rad, within
4.3e-4 rad. The stitch's dΨ/df at f_t within 1e-5 relative; the SNR of
precessing_signal_white_fd within 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics import waveforms as JW
from posteriflow_tpu.physics.constants import FREQS
from posteriflow_tpu.physics.psd import default_network_asd as jasd
from posteriflow_tpu.physics.waveforms import precession as JPR
from posteriflow_tpu.physics.waveforms.taylorf2 import \
    taylorf2_amp_phase as jtf2_ap
from posteriflow_torch.physics import waveforms as TW
from posteriflow_torch.physics.psd import default_network_asd as tasd
from posteriflow_torch.physics.waveforms import imr as TIMR
from posteriflow_torch.physics.waveforms import precession as TPR
from torch_sim_helpers import one_torch_thread  # noqa: F401

F = np.asarray(FREQS, np.float32)
# m1, m2, chi1, chi2, d_L, theta_jn, phase: one BBH, BNS and NSBH each
CASES = {
    "bbh": [36.0, 29.0, 0.3, -0.1, 400.0, 0.4, 1.2],
    "bns": [1.6, 1.3, 0.03, 0.02, 40.0, 2.1, 4.0],
    "nsbh": [8.0, 1.4, 0.7, 0.04, 100.0, 1.2, 0.5],
}
PSI_STEPS = 16


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _cols(c):
    return [torch.tensor([[float(v)]]) for v in c]


def _complex_bar(c) -> float:
    """The complex-value bar for case c as a share of the peak."""
    _, psi = jtf2_ap(jnp.asarray(F), *[c[i] for i in (0, 1, 2, 3, 4, 6)])
    psi = np.asarray(psi)[F >= 20.0]
    return max(2e-3, PSI_STEPS * float(np.spacing(
        np.float32(np.abs(psi).max()))))


def _hold(ref, got, c):
    ref, got = np.asarray(ref)[0], got.numpy()[0]
    assert got.dtype == np.complex64 and got.shape == ref.shape
    pk = np.abs(ref).max()
    assert np.max(np.abs(np.abs(got) - np.abs(ref))) <= 1e-5 * pk
    assert np.max(np.abs(got - ref)) <= _complex_bar(c) * pk


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("name", list(JW.APPROXIMANTS))
def test_approximants_match_jax(name, kind):
    """Each APPROXIMANTS entry of the port against JAX's entry of the same
    name, on one BBH, BNS and NSBH signal."""
    assert set(TW.APPROXIMANTS) == set(JW.APPROXIMANTS)
    c = CASES[kind]
    jhp, jhc = jax.jit(lambda: JW.APPROXIMANTS[name](jnp.asarray(F), *c))()
    thp, thc = TW.APPROXIMANTS[name](torch.from_numpy(F), *_cols(c))
    _hold(np.asarray(jhp)[None], thp, c)
    _hold(np.asarray(jhc)[None], thc, c)


def test_imr_alias_and_batch():
    """imr_polarizations is the matter-aware PhenomD, as in JAX; a batch
    of the three cases as [3, 1] columns gives each case's own row."""
    assert TW.imr_polarizations is TW.phenomd_matter_polarizations
    rows = np.array(list(CASES.values()), np.float32)
    cols = [torch.from_numpy(rows[:, i:i + 1]) for i in range(7)]
    hp, hc = TW.imr_polarizations(torch.from_numpy(F), *cols)
    assert hp.shape == (3, F.size)
    for i, c in enumerate(CASES.values()):
        one, _ = TW.imr_polarizations(torch.from_numpy(F), *_cols(c))
        np.testing.assert_allclose(hp[i].numpy(), one[0].numpy(),
                                   rtol=0, atol=1e-6 * float(
                                       one.abs().max()))


@pytest.mark.parametrize("chi_p", [0.0, 0.3, 0.6])
@pytest.mark.parametrize("kind", list(CASES))
def test_phenomp_matches_jax(kind, chi_p):
    c = CASES[kind]
    alpha0 = 0.7
    jhp, jhc = jax.jit(lambda: JW.phenomp_polarizations(
        jnp.asarray(F), *c, chi_p=chi_p, alpha0=alpha0))()
    thp, thc = TW.phenomp_polarizations(torch.from_numpy(F), *_cols(c),
                                        chi_p=chi_p, alpha0=alpha0)
    _hold(np.asarray(jhp)[None], thp, c)
    _hold(np.asarray(jhc)[None], thc, c)


@pytest.mark.parametrize("kind", list(CASES))
def test_stitch_slope_matches_jax_grad(kind):
    """imr_stitch's dΨ/df at f_t = f_RD/2 by torch.autograd against
    jax.grad of the TaylorF2 phase (imr.py:94-95), also under no_grad."""
    m1, m2, a1, a2, d, _, ph = CASES[kind]
    mf, af = JW.final_state(m1, m2, a1, a2)
    f_t = 0.5 * float(JW.qnm_frequency(mf, af)[0])

    def psi(f):
        return jtf2_ap(jnp.reshape(f, (1,)), m1, m2, a1, a2, d, ph)[1][0]

    ref_psi = float(psi(jnp.float32(f_t)))
    ref = float(jax.grad(psi)(jnp.float32(f_t)))
    cols = _cols([m1, m2, a1, a2, d, ph])
    with torch.no_grad():
        tmf, taf = TIMR.final_state(*cols[:4])
        tf_t = 0.5 * TIMR.qnm_frequency(tmf, taf)[0]
        assert abs(float(tf_t) - f_t) <= 1e-5 * f_t
        _, psi_t, dpsi_t = TIMR._stitch_point(
            torch.tensor([[f_t]], dtype=torch.float32),
            (*cols[:5], cols[5], 20.0))
    assert not dpsi_t.requires_grad
    assert abs(float(psi_t) - ref_psi) <= 1e-5 * abs(ref_psi)
    assert abs(float(dpsi_t) - ref) <= 1e-5 * abs(ref)


THETA = np.array([36.0, 29.0, 600.0, 1.1, -0.4, 1.05, 0.9, 1.2, 0.05, 0.3,
                  -0.1], np.float32)


@pytest.mark.parametrize("chi_p", [0.0, 0.3, 0.6])
def test_precessing_signal_white_fd_matches_jax(chi_p):
    """One precessing signal's whitened [3, N_RFFT] strain: its SNR within
    1e-5 relative; the values within the complex bar of the BBH case."""
    ref = np.asarray(jax.jit(JPR.precessing_signal_white_fd)(
        jnp.asarray(THETA), jnp.float32(chi_p), jasd()))
    got = TPR.precessing_signal_white_fd(torch.from_numpy(THETA), chi_p,
                                         tasd(device="cpu")).numpy()
    assert got.shape == ref.shape == (3, F.size)
    assert got.dtype == np.complex64
    snr_ref = np.sqrt(np.sum(np.abs(ref) ** 2))
    snr = np.sqrt(np.sum(np.abs(got) ** 2))
    assert abs(snr - snr_ref) <= 1e-5 * snr_ref
    assert np.max(np.abs(got - ref)) <= 2e-3 * np.abs(ref).max()
