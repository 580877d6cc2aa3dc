"""The port's waveforms against the JAX package's on one BBH, BNS, NSBH and
extreme-mass-ratio precessing draw (tests/torch_sim_helpers.DRAWS):
PhenomD × matter effects, the decimated precession twist, the whitened
per-detector FD strain of both branches, and the amplitude-only gate SNR.

Tolerances. Ψ reaches ~1e4 rad at 20 Hz, where one float32 step is ~1e-3
rad, so waveforms are held by match and norm, never by per-bin phase:
match ≥ 1 − 1e-5 and norm within 1e-5 relative, per detector (measured
≤ 7e-7 and ≤ 1.4e-6), and the twist's (SP, SM) pair likewise (each factor
alone: see test_twist_factors_decimated). The amplitude is held per bin to rtol 1e-4 where it
exceeds 1e-6 of its peak (measured ≤ 1e-5), the gate SNR to 1e-5 relative
(measured ≤ 1.4e-6). The residue is float32 rounding: the port takes
x^{1/3} through float64 where JAX calls cbrt, and its own exp, log and
trig."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics import simulator as jsim
from posteriflow_tpu.physics.psd import default_network_asd as jasd
from posteriflow_tpu.physics.waveforms.precession import (
    spin_components as jspin, twist_factors_decimated as jtwist)
from posteriflow_tpu.physics.waveforms.tidal import \
    phenomd_matter_amp_phase as jamp_phase
from posteriflow_torch.physics import simulator as tsim
from posteriflow_torch.physics.constants import FREQS
from posteriflow_torch.physics.psd import default_network_asd as tasd
from posteriflow_torch.physics.waveforms.precession import (
    spin_components as tspin, twist_factors_decimated as ttwist)
from posteriflow_torch.physics.waveforms.tidal import \
    phenomd_matter_amp_phase as tamp_phase
from torch_sim_helpers import DRAWS, draws_array, match

KINDS = list(DRAWS)
F32 = np.asarray(FREQS, np.float32)
MATCH_TOL, NORM_TOL, AMP_RTOL, SNR_RTOL = 1e-5, 1e-5, 1e-4, 1e-5


@jax.jit
def _jax_all(p15, asd):
    def one(p):
        amp, psi = jamp_phase(jnp.asarray(F32), p[0], p[1], p[9], p[10],
                              p[2], p[7])
        c1, c2, cp = jspin(p[9], p[10], p[11], p[12], p[13], p[0], p[1])
        sp, sm = jtwist(F32, p[0], p[1], c1, c2, cp, p[5], alpha0=p[14],
                        decimate=8)
        return (amp, psi, sp, sm,
                jsim.signal_white_fd(p[:11], asd),
                jsim.signal_white_fd(p, asd),
                jsim.signal_snr_amp_only(p[:11], asd, decimate=4),
                jsim.signal_snr_amp_only(p, asd, decimate=2))
    return jax.vmap(one)(p15)


@pytest.fixture(scope="module")
def both():
    p = draws_array(15)
    j = [np.asarray(a) for a in _jax_all(jnp.asarray(p), jasd())]
    tp = torch.from_numpy(p)
    c = [tp[:, i:i + 1] for i in range(15)]
    asd = tasd(device="cpu")
    amp, psi = tamp_phase(torch.from_numpy(F32), c[0], c[1], c[9], c[10],
                          c[2], c[7])
    c1, c2, cp = tspin(c[9], c[10], c[11], c[12], c[13], c[0], c[1])
    sp, sm = ttwist(F32, c[0], c[1], c1, c2, cp, c[5], alpha0=c[14],
                    decimate=8)
    t = [amp, psi, sp, sm, tsim.signal_white_fd(tp[:, :11], asd),
         tsim.signal_white_fd(tp, asd),
         tsim.signal_snr_amp_only(tp[:, :11], asd, decimate=4),
         tsim.signal_snr_amp_only(tp, asd, decimate=2)]
    return j, [a.numpy() for a in t]


def _hold(a_t, a_j):
    m = match(a_t, a_j)
    norm = np.linalg.norm(a_t.astype(np.complex128)) / np.linalg.norm(
        a_j.astype(np.complex128)) - 1.0
    assert m >= 1.0 - MATCH_TOL, m
    assert abs(norm) <= NORM_TOL, norm


@pytest.mark.parametrize("kind", KINDS)
def test_phenomd_matter_amp_phase(both, kind):
    j, t = both
    k = KINDS.index(kind)
    amp_j, amp_t = j[0][k], t[0][k]
    live = amp_j > 1e-6 * amp_j.max()
    np.testing.assert_allclose(amp_t[live], amp_j[live], rtol=AMP_RTOL)
    assert (amp_t[~live] <= 1e-6 * amp_j.max() * (1 + AMP_RTOL)).all()
    _hold(amp_t * np.exp(-1j * t[1][k].astype(np.float64)),
          amp_j * np.exp(-1j * j[1][k].astype(np.float64)))


@pytest.mark.parametrize("kind", KINDS)
def test_twist_factors_decimated(both, kind):
    """The twist enters the waveform only as SP ± SM, so the pair is held
    as one vector. Each factor alone: the match as above, the norm to
    5e-5. α and ε are cumulative sums up to ~60 rad; JAX's float32 cumsum
    is off a float64 sum by 5.6e-5 rad on the NSBH draw (the port's by
    1.7e-5), which moves up to 2e-5 of the norm from SM to SP."""
    j, t = both
    k = KINDS.index(kind)
    _hold(np.concatenate([t[2][k], t[3][k]]),
          np.concatenate([j[2][k], j[3][k]]))
    for idx in (2, 3):                     # SP, SM
        assert match(t[idx][k], j[idx][k]) >= 1.0 - MATCH_TOL
        np.testing.assert_allclose(np.linalg.norm(t[idx][k]),
                                   np.linalg.norm(j[idx][k]), rtol=5e-5)


@pytest.mark.parametrize("n_params", [11, 15], ids=["aligned", "precessing"])
@pytest.mark.parametrize("kind", KINDS)
def test_signal_white_fd(both, kind, n_params):
    j, t = both
    k, idx = KINDS.index(kind), 4 if n_params == 11 else 5
    assert t[idx].shape == (4, 3, F32.size) and t[idx].dtype == np.complex64
    for det in range(3):
        _hold(t[idx][k, det], j[idx][k, det])


@pytest.mark.parametrize("n_params", [11, 15], ids=["aligned", "precessing"])
@pytest.mark.parametrize("kind", KINDS)
def test_signal_snr_amp_only(both, kind, n_params):
    j, t = both
    k, idx = KINDS.index(kind), 6 if n_params == 11 else 7
    np.testing.assert_allclose(t[idx][k], j[idx][k], rtol=SNR_RTOL)


def test_amplitude_without_phase_is_the_same():
    """phase=False skips the phase chain and leaves the amplitude's bits."""
    tp = torch.from_numpy(draws_array(11))
    c = [tp[:, i:i + 1] for i in range(11)]
    f = torch.from_numpy(F32[::4])
    a1, psi = tamp_phase(f, c[0], c[1], c[9], c[10], c[2], c[7])
    a2, none = tamp_phase(f, c[0], c[1], c[9], c[10], c[2], c[7],
                          phase=False)
    assert none is None and psi.shape == a1.shape
    assert torch.equal(a1, a2)


def test_joins_work_under_no_grad():
    """PhenomD takes its join slopes by autograd; the serving path runs
    under torch.no_grad and must get the same waveform."""
    tp = torch.from_numpy(draws_array(15))
    asd = tasd(device="cpu")
    free = tsim.signal_white_fd(tp, asd)
    with torch.no_grad():
        held = tsim.signal_white_fd(tp, asd)
    assert torch.equal(free, held)
