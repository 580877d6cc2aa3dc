"""Importance sampling with a flow against the JAX package: the JAX tests'
TINY engine (conditioner in float32) and the same weights in the port on
the CPU, on JAX's weak BBH injection (1800 Mpc; test_inference.py's
tempered-ladder case).

Tolerances: symmetrized_log_q within 1e-4 nats; the device sweep with
g0 = flow, fed JAX's draws, within 1e-5 relative per particle; the direct
path's ESS and normalized weights within 1e-4; a forced tempered path
(pad_block 128, JAX's draws in every sweep) with the same β ladder and
acceptance, log Z within 0.05 nats and the weighted means of m1, m2 and
d within 1%."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu import PARAM_NAMES
from posteriflow_tpu.inference import importance as J
from posteriflow_tpu.inference.pipeline import infer as jinfer
from posteriflow_tpu.inference.preprocessing import prepare_simulated as jprep
from posteriflow_torch.inference import importance as T
from torch_is_helpers import BBH, engines, jax_sweep_draws, use_jax_draws

WEAK = dict(BBH, luminosity_distance=1800.0)


@pytest.fixture(scope="module")
def setup():
    jeng, teng = engines()
    prep = jprep([WEAK], seed=6)
    res = jinfer(jeng, data=prep, n_samples=300, seed=6)
    jctx = jeng.encode(jnp.asarray(prep.strain)[None],
                       jnp.asarray(prep.asd_bands)[None])[0]
    tctx = teng.encode(prep.strain[None], prep.asd_bands[None])[0]
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-5)
    return jeng, teng, prep, res, jctx, tctx


def _near_truth(n: int, seed: int) -> np.ndarray:
    """Draws around the injection (masses ±1, distance ±20%, t_c ±10 ms,
    any phase), folded into m1 >= m2."""
    rng = np.random.default_rng(seed)
    s = np.repeat(np.array([[WEAK[k] for k in PARAM_NAMES]], np.float32),
                  n, 0)
    s[:, 0] += rng.normal(0, 1.0, n)
    s[:, 1] += rng.normal(0, 1.0, n)
    s[:, 2] *= rng.uniform(0.8, 1.2, n)
    s[:, 7] = rng.uniform(0, 2 * np.pi, n)
    s[:, 8] += rng.normal(0, 0.01, n)
    s[:, :2] = np.sort(s[:, :2], axis=1)[:, ::-1]
    return s


def test_symmetrized_log_q_matches_jax(setup):
    jeng, teng, _, res, jctx, tctx = setup
    theta = np.concatenate([res.samples[:100], _near_truth(50, 1)])
    theta = theta.astype(np.float32)
    ref = np.asarray(J.symmetrized_log_q(jeng, jctx, 1, jnp.asarray(theta),
                                         pad_block=128))
    got = T.symmetrized_log_q(teng, tctx, 1, theta, pad_block=128)
    assert got.shape == (150,) and got.device == teng.device
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def _core(t):
    return (-0.5 * ((t[:, 0] - 36.0) / 4.0) ** 2
            - 0.5 * ((t[:, 2] - 1800.0) / 300.0) ** 2)


def test_fused_move_with_flow_anchor_matches_jax(setup):
    """g0 = flow: each proposal's anchor density is the symmetrized flow
    density plus the per-particle correction."""
    jeng, teng, _, _, jctx, tctx = setup
    n, seed, beta = 128, 21, 0.4
    cur = _near_truth(n, 2).astype(np.float64)
    ll = np.asarray(_core(cur), np.float64)
    lp = np.asarray(T.host_log_prior(device="cpu")(cur), np.float64)
    lg0 = np.asarray(J.symmetrized_log_q(jeng, jctx, 0, jnp.asarray(
        cur, jnp.float32), pad_block=n), np.float64)
    corr = np.random.default_rng(3).normal(0, 0.1, n)
    x = T._to_slow(cur, marg=True)
    chol = 0.3 * np.linalg.cholesky(np.cov(x.T) + 1e-6 * np.eye(9))
    jmove = J._make_fused_move(jeng, jctx, 0, _core, (), marg=True)
    jout = jmove(cur, ll, lp, lg0 + corr, corr, beta, chol, seed)
    tmove = T._make_fused_move(teng, tctx, 0, _core, marg=True)
    nrm, uni = jax_sweep_draws(seed, 5, n, 9)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    tout = tmove.sweep(t(cur), t(ll), t(lp), t(lg0 + corr), t(corr),
                       torch.tensor(beta, dtype=torch.float32), t(chol),
                       nrm, uni)
    for k in range(4):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], rtol=1e-5,
                                   atol=1e-5)
    assert float(tout[4]) == pytest.approx(jout[4], abs=1e-7)
    assert 0.05 < jout[4] < 0.95


def test_importance_correct_direct_matches_jax(setup):
    jeng, teng, prep, _, jctx, tctx = setup
    samples = _near_truth(256, 0)
    railed = np.zeros(256, bool)
    railed[:6] = True
    kw = dict(marginalized=True, pad_block=128, min_ess_frac=0.0, seed=2)
    ref = J.importance_correct(
        jeng, jctx, 0, samples, None, railed,
        J.make_marginalized_log_likelihood(prep.strain), **kw)
    got = T.importance_correct(
        teng, tctx, 0, samples, None, railed,
        T.make_marginalized_log_likelihood(prep.strain, device="cpu"), **kw)
    assert got.samples.shape == (250, 11) and got.n_stages == 1
    np.testing.assert_array_equal(got.samples, ref.samples)
    assert 5.0 < got.ess < 250.0                  # a non-trivial ESS
    assert got.ess == pytest.approx(ref.ess, abs=1e-4)
    np.testing.assert_allclose(got.weights, ref.weights, atol=1e-4)
    assert got.log_evidence_ratio == pytest.approx(ref.log_evidence_ratio,
                                                   abs=1e-3)


def test_importance_correct_tempered_matches_jax(setup, monkeypatch):
    jeng, teng, prep, res, jctx, tctx = setup
    use_jax_draws(monkeypatch)
    kw = dict(marginalized=True, pad_block=128, min_ess_frac=0.999,
              max_stages=4)
    ref = J.importance_correct(
        jeng, jctx, 0, res.samples, res.log_prob, res.railed,
        J.make_marginalized_log_likelihood(prep.strain), **kw)
    got = T.importance_correct(
        teng, tctx, 0, res.samples, res.log_prob, res.railed,
        T.make_marginalized_log_likelihood(prep.strain, device="cpu"), **kw)
    assert got.n_stages == 4 and len(got.samples) == 128
    assert got.beta_ladder == ref.beta_ladder
    assert got.mcmc_acceptance == ref.mcmc_acceptance
    assert got.converged == ref.converged
    assert abs(got.log_evidence_ratio - ref.log_evidence_ratio) < 0.05
    assert abs(got.weights.sum() - 1.0) < 1e-6
    for col in (0, 1, 2):
        mu_t = np.sum(got.weights * got.samples[:, col])
        mu_j = np.sum(ref.weights * ref.samples[:, col])
        assert abs(mu_t - mu_j) <= 0.01 * abs(mu_j), (col, mu_t, mu_j)


def test_host_log_prior_defaults_to_the_card():
    """host_log_prior follows the port's rule for entry points, device=
    with a default of "cuda"; on the CPU it is asked for by name and gives
    log_prior_bbh's values."""
    import inspect
    default = inspect.signature(T.host_log_prior).parameters["device"]
    assert default.default == "cuda"
    cur = _near_truth(8, 5)
    got = T.host_log_prior(device="cpu")(cur)
    assert got.dtype == np.float32 and got.shape == (8,)
    ref = T.log_prior_bbh(torch.from_numpy(cur), T.PriorConfig()).numpy()
    np.testing.assert_array_equal(got, ref)
