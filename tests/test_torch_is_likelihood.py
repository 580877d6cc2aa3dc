"""The Whittle likelihoods of importance sampling against the JAX package:
make_log_likelihood and make_marginalized_log_likelihood on the strain of
JAX's prepare_simulated (passed as numpy), at 11-D and at 15-D, with and
without an extracted-signal residual, and the JAX package's own property
tests (tests/test_inference.py:260-358) on the port's noise-free
injections.

Tolerance: per θ, |Δ log L| <= 1e-3·(1 + ½‖h_w‖² + |Re⟨d, h_w⟩|): the
likelihood is a difference of two float32 terms of size SNR², each summed
over 3 × 8193 bins in another order in each package. The worst gap
measured is printed (pytest -s)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu import PARAM_NAMES, PARAM_NAMES_PRECESSING
from posteriflow_tpu.inference import importance as J
from posteriflow_tpu.inference.preprocessing import prepare_simulated as jprep
from posteriflow_torch.inference import importance as T
from posteriflow_torch.inference.preprocessing import prepare_simulated
from posteriflow_torch.physics.simulator import design_asd, signal_white_fd
from torch_is_helpers import BBH, TRUTH

PREC = dict(BBH, a1=0.5, a2=0.3, tilt_1=1.0, tilt_2=2.1, phi_12=0.7,
            phi_jl=3.0)


def _thetas(truth: np.ndarray, seed: int) -> np.ndarray:
    """The truth, the truth at another phase and t_c, and perturbations
    of every parameter (masses by up to 2, distance by up to 30%)."""
    rng = np.random.default_rng(seed)
    p = truth.shape[1]
    rows = [truth[0], truth[0].copy()]
    rows[1][7], rows[1][8] = 4.0, -0.9
    for _ in range(10):
        r = truth[0].copy()
        r[0] += rng.uniform(-2, 2)
        r[1] += rng.uniform(-2, 0)
        r[2] *= rng.uniform(0.7, 1.3)
        r[3:] += rng.normal(size=p - 3) * 0.05
        r[7] = rng.uniform(0, 2 * np.pi)
        r[8] = rng.uniform(-1.4, 1.4)
        rows.append(r)
    return np.asarray(rows, np.float32)


def _scale(theta: np.ndarray, strain: np.ndarray) -> np.ndarray:
    """1 + ½‖h_w‖² + |Re⟨d, h_w⟩| per θ (float64, from the port's
    waveform)."""
    h = signal_white_fd(torch.from_numpy(theta),
                        design_asd("cpu")).numpy().astype(np.complex128)
    d = np.fft.rfft(strain.astype(np.float64), axis=-1) / np.sqrt(8192.0)
    return (1.0 + 0.5 * np.sum(np.abs(h) ** 2, axis=(1, 2))
            + np.abs(np.sum(np.real(d[None] * np.conj(h)), axis=(1, 2))))


CASES = {11: (BBH, PARAM_NAMES), 15: (PREC, PARAM_NAMES_PRECESSING)}


@pytest.fixture(scope="module", params=[11, 15])
def event(request):
    inj, names = CASES[request.param]
    prep = jprep([inj], seed=4, param_names=names)
    truth = np.array([[inj[k] for k in names]], np.float32)
    theta = _thetas(truth, seed=request.param)
    # a residual: a fifth of another signal's whitened FD strain
    other = truth.copy()
    other[0, 0], other[0, 1], other[0, 8] = 20.0, 12.0, -0.5
    res = 0.2 * signal_white_fd(torch.from_numpy(other),
                                design_asd("cpu"))[0].numpy()
    return prep.strain, theta, res


@pytest.mark.parametrize("kind", ["make_log_likelihood",
                                  "make_marginalized_log_likelihood"])
def test_likelihood_matches_jax(event, kind):
    strain, theta, res = event
    scale = _scale(theta, strain)
    worst = 0.0
    for residual in (None, res):
        jf = getattr(J, kind)(strain, residual_fd=None if residual is None
                              else jnp.asarray(residual))
        tf = getattr(T, kind)(strain, residual_fd=residual, device="cpu")
        assert tf.is_marginalized == jf.is_marginalized
        ref = np.asarray(jf(jnp.asarray(theta)), np.float64)
        got = tf(theta).astype(np.float64)
        assert got.shape == (len(theta),) and np.isfinite(got).all()
        gap = np.abs(got - ref) / scale
        worst = max(worst, float(gap.max()))
        assert (gap <= 1e-3).all(), (kind, residual is not None, gap.max())
        # the device hook gives the same numbers as the host call
        core = tf.core(torch.from_numpy(theta)).numpy()
        np.testing.assert_array_equal(core, got.astype(np.float32))
    print(f"\n{kind} P={theta.shape[1]}: worst |Δ|/scale {worst:.3e}")


def test_likelihood_peaks_at_truth():
    """The full likelihood prefers the injected parameters to a wrong-mass
    alternative and beats the noise-only model (noise-free injection)."""
    prep = prepare_simulated([BBH], seed=5, add_noise=False, device="cpu")
    log_l = T.make_log_likelihood(prep.strain, device="cpu")
    wrong = TRUTH.copy()
    wrong[0, 0], wrong[0, 1] = 80.0, 10.0
    ll = log_l(np.vstack([TRUTH, wrong]))
    assert ll[0] > ll[1] + 10.0, ll
    assert ll[0] > 0.0


def test_marginalized_likelihood_properties():
    """Independent of phase and t_c, prefers the true slow parameters, and
    never exceeds the full likelihood's peak (it is an average) while
    staying within the marginalization volume of it."""
    prep = prepare_simulated([BBH], seed=11, add_noise=False, device="cpu")
    log_lm = T.make_marginalized_log_likelihood(prep.strain, device="cpu")
    shifted = TRUTH.copy()
    shifted[0, 7], shifted[0, 8] = 4.0, -0.9
    wrong = TRUTH.copy()
    wrong[0, 0], wrong[0, 1] = 80.0, 10.0
    ll = log_lm(np.vstack([TRUTH, shifted, wrong]))
    assert abs(ll[0] - ll[1]) < 1e-3, ll
    assert ll[0] > ll[2] + 10.0, ll
    ll_full = float(T.make_log_likelihood(prep.strain, device="cpu")(
        TRUTH)[0])
    assert ll[0] <= ll_full + 1e-3
    assert ll[0] > ll_full - 25.0
