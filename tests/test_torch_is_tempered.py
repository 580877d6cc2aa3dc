"""The host SMC ladder, the device SMC sweep and the prior SMC against the
JAX package, on synthetic likelihoods (no waveform):

- `_tempered_is` given the same numpy callables: bit for bit (samples,
  weights, log-weights, ladder, acceptance, log Z) on a path that takes
  β = 1 at once, a tempered path and the marginalized (slow-space) path.
- `_make_fused_move` with g0 = prior, fed JAX's draws rebuilt from its key
  (tests/torch_is_helpers.py): accept decisions equal wherever
  |log u − Δ| > 1e-3 (Δ in float64 from the port's pieces), particle
  states within 1e-5 relative; a five-step sweep likewise end to end.
- `run_smc_prior` on JAX's own synthetic likelihood passes JAX's bars
  (tests/test_inference.py:415-450) and its log Z is within 0.3 of JAX's
  run (the prior is float32 in both packages, computed by XLA and by
  torch, so the ladders may part in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.inference import importance as J
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.prior import log_prior_bbh as jlog_prior
from posteriflow_tpu.prior import sample_prior_bbh
from posteriflow_torch.inference import importance as T
from posteriflow_torch.prior import PriorConfig as TPrior
from posteriflow_torch.prior import log_prior_bbh as tlog_prior
from torch_is_helpers import jax_sweep_draws

_jprior = jax.jit(jax.vmap(jlog_prior))


def log_prior_np(t):
    """One numpy prior callable, handed to both packages."""
    return np.asarray(_jprior(jnp.asarray(t, jnp.float32)), np.float64)


def _prior_cloud(seed: int, n: int):
    theta = sample_prior_bbh(np.random.default_rng(seed), n)
    lp = log_prior_np(theta)
    return theta, lp


def _mild(t):
    t = np.asarray(t)
    return -0.5 * ((t[:, 0] - 40.0) / 30.0) ** 2


def _sharp(t):
    t = np.asarray(t)
    return (-0.5 * ((t[:, 0] - 35.0) / 2.0) ** 2
            - 0.5 * ((t[:, 2] - 800.0) / 100.0) ** 2)


def _fast_free(t):
    t = np.asarray(t)
    return (-0.5 * ((t[:, 0] - 30.0) / 2.5) ** 2
            - 0.5 * ((t[:, 2] - 700.0) / 120.0) ** 2)


@pytest.mark.parametrize("case", [("direct", _mild, False, 3),
                                  ("tempered", _sharp, False, 3),
                                  ("marginalized", _fast_free, True, 5)],
                         ids=lambda c: c[0])
def test_tempered_is_is_bit_equal(case):
    name, log_l, marg, seed = case
    theta, lp = _prior_cloud(seed=7 + seed, n=1500)
    ll = np.asarray(log_l(theta), np.float64)
    kw = dict(max_stages=25, seed=seed, marginalized=marg)
    a = J._tempered_is(theta, lp.copy(), ll, lp, log_l, log_prior_np, **kw)
    b = T._tempered_is(theta, lp.copy(), ll, lp, log_l, log_prior_np, **kw)
    if name == "direct":
        assert b.n_stages == 1 and b.converged
    else:
        assert b.n_stages > 1 and b.converged
    for f in ("samples", "weights", "log_weights"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for f in ("ess", "efficiency", "log_evidence_ratio", "n_stages",
              "beta_ladder", "converged", "mcmc_acceptance"):
        assert getattr(b, f) == getattr(a, f), f


def _core(t):
    """The sweeps' synthetic likelihood: jnp arrays or tensors alike."""
    return (-0.5 * ((t[:, 0] - 35.0) / 4.0) ** 2
            - 0.5 * ((t[:, 1] - 28.0) / 4.0) ** 2
            - 0.5 * ((t[:, 2] - 800.0) / 150.0) ** 2)


def _sweep_inputs(marg: bool, n: int = 256, seed: int = 2):
    """A cloud near the synthetic peak, its densities (float32), β and the
    step's Cholesky factor."""
    rng = np.random.default_rng(seed)
    theta = sample_prior_bbh(rng, 4 * n)
    keep = np.argsort(-_core(theta))[:n]
    cur = theta[keep]
    lp = log_prior_np(cur)
    ll = np.asarray(_core(cur), np.float64)
    x = T._to_slow(cur, marg=marg)
    chol = 0.5 * np.linalg.cholesky((2.38 ** 2 / x.shape[1])
                                    * (np.cov(x.T) + 1e-12 * np.eye(
                                        x.shape[1])))
    return cur, ll, lp, lp.copy(), np.zeros(n), 0.37, chol


def _both_sweeps(marg: bool, n_mcmc: int, seed: int):
    cur, ll, lp, lg0, corr, beta, chol = _sweep_inputs(marg)
    jmove = J._make_fused_move(None, None, 0, _core, (),
                               marg=marg, n_mcmc=n_mcmc, g0="prior",
                               prior_cfg=JPrior())
    jout = jmove(cur, ll, lp, lg0, corr, beta, chol, seed)
    tmove = T._make_fused_move(None, None, 0, _core, marg=marg,
                               n_mcmc=n_mcmc, g0="prior",
                               prior_cfg=TPrior(), device="cpu")
    nrm, uni = jax_sweep_draws(seed, n_mcmc, len(cur), chol.shape[0])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))
    tout = tmove.sweep(t(cur), t(ll), t(lp), t(lg0), t(corr),
                       torch.tensor(beta, dtype=torch.float32), t(chol),
                       nrm, uni)
    return (cur, ll, lp, beta, chol, nrm, uni), jout, tout


@pytest.mark.parametrize("marg", [False, True])
def test_fused_move_step_decisions_match_jax(marg):
    """One step: the port accepts what JAX accepts wherever the test's
    float64 log-ratio is more than 1e-3 from log u."""
    (cur, ll, lp, beta, chol, nrm, uni), jout, tout = _both_sweeps(
        marg, n_mcmc=1, seed=11)
    # the step in float64 from the port's own pieces
    x = T._to_slow(cur, marg=marg)
    xp = x + nrm[0].double().numpy() @ chol.T
    thp = T._reassemble(xp, cur, marg=marg)
    thp_t = torch.from_numpy(thp)
    lpp = tlog_prior(thp_t, TPrior()).numpy()
    jac = np.sum(np.log(np.maximum(cur[:, :3], 1e-10)), axis=1)
    jacp = np.sum(np.log(np.maximum(thp[:, :3], 1e-10)), axis=1)
    tgt = beta * (ll + lp) + (1 - beta) * lp + jac
    tgtp = beta * (_core(thp) + lpp) + (1 - beta) * lpp + jacp
    tgtp = np.where(xp[:, 1] <= 0.0, tgtp, -np.inf)
    margin = np.abs(np.log(uni[0].double().numpy()) - (tgtp - tgt))
    clear = ~(margin <= 1e-3)
    cur32 = cur.astype(np.float32)
    j_acc = np.any(jout[0].astype(np.float32) != cur32, axis=1)
    t_acc = np.any(tout[0].numpy() != cur32, axis=1)
    assert 0.1 < t_acc.mean() < 0.95                   # both kinds occur
    np.testing.assert_array_equal(t_acc[clear], j_acc[clear])
    same = t_acc == j_acc
    np.testing.assert_allclose(tout[0].numpy()[same], jout[0][same],
                               rtol=1e-5)
    for k in (1, 2, 3):
        np.testing.assert_allclose(tout[k].numpy()[same], jout[k][same],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("marg", [False, True])
def test_fused_move_sweep_matches_jax(marg):
    """Five steps: every particle's state and densities within 1e-5
    relative of JAX's, and the same acceptance."""
    _, jout, tout = _both_sweeps(marg, n_mcmc=5, seed=12)
    for k in range(4):
        np.testing.assert_allclose(tout[k].numpy(), jout[k], rtol=1e-5,
                                   atol=1e-5)
    assert float(tout[4]) == pytest.approx(jout[4], abs=1e-7)
    assert 0.05 < jout[4] < 0.95
    # the host entry draws its own normals and uniforms, and hands the
    # cloud back as float64 with one acceptance
    cur, ll, lp, lg0, corr, beta, chol = _sweep_inputs(marg)
    tmove = T._make_fused_move(None, None, 0, _core, marg=marg, g0="prior",
                               device="cpu")
    out = tmove(cur, ll, lp, lg0, corr, beta, chol, 5)
    assert out[0].dtype == np.float64 and out[0].shape == cur.shape
    assert 0.0 < out[4] < 1.0


def test_run_smc_prior_matches_jax_and_direct_mc():
    def log_l_fn(t):
        t = np.asarray(t)
        return (-0.5 * ((t[:, 0] - 35.0) / 2.0) ** 2
                - 0.5 * ((t[:, 1] - 28.0) / 2.0) ** 2
                - 0.5 * ((t[:, 2] - 800.0) / 100.0) ** 2)

    res = T.run_smc_prior(log_l_fn, n=2048, seed=3, marginalized=True)
    assert res.converged, res.beta_ladder
    assert res.n_stages > 1
    assert 0.0 < res.efficiency < 1.0 - 1e-9
    big = sample_prior_bbh(np.random.default_rng(11), 200_000)
    direct = T._finalize(big.astype(np.float32), log_l_fn(big))
    assert abs(res.log_evidence_ratio - direct.log_evidence_ratio) < 0.5
    for col in (0, 1, 2):
        mu_s = np.sum(res.weights * res.samples[:, col])
        mu_d = np.sum(direct.weights * direct.samples[:, col])
        assert abs(mu_s - mu_d) / max(abs(mu_d), 1.0) < 0.08, (col, mu_s,
                                                               mu_d)
    ref = J.run_smc_prior(log_l_fn, n=2048, seed=3, marginalized=True)
    assert abs(res.log_evidence_ratio - ref.log_evidence_ratio) < 0.3
