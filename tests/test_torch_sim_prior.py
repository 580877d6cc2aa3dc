"""The port's prior against the JAX package's by distribution: the two
random streams differ, so 4096 events (every slot) from each, with fixed
seeds, are compared per parameter by a two-sample Kolmogorov-Smirnov test
(p > 1e-3) and the n_sig frequencies within 4σ of each other."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from posteriflow_tpu import PARAM_NAMES_PRECESSING
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.prior import sample_batch as jsample_batch
from posteriflow_torch import prior as tprior

N_EVENTS, P_MIN, N_SIGMA = 4096, 1e-3, 4.0
CFGS = {
    "aligned": JPrior(),
    # the flagship's (npe_r7_best/meta.json)
    "precessing": JPrior(precessing=True),
    "premerger_oversampled": JPrior(premerger_fraction=0.5,
                                    mc_oversample=1.0, max_signals=2,
                                    distance_prior="uniform"),
}


@jax.jit
def _jax_all(key):
    return {name: jsample_batch(jax.random.fold_in(key, i), N_EVENTS, cfg)
            for i, (name, cfg) in enumerate(CFGS.items())}


@pytest.fixture(scope="module")
def draws():
    j = jax.tree_util.tree_map(np.asarray, _jax_all(jax.random.PRNGKey(0)))
    g = torch.Generator().manual_seed(0)
    t = {name: tuple(a.numpy() for a in tprior.sample_batch(
        N_EVENTS, tprior.PriorConfig(**dataclasses.asdict(cfg)), g, "cpu"))
        for name, cfg in CFGS.items()}
    return j, t


CASES = [(name, i) for name, cfg in CFGS.items()
         for i in range(cfg.n_params)]


@pytest.mark.parametrize(
    "name,i", CASES,
    ids=[f"{n}-{PARAM_NAMES_PRECESSING[i]}" for n, i in CASES])
def test_parameter_distribution(draws, name, i):
    j, t = draws
    (jp, _), (tp, _) = j[name], t[name]
    assert tp.shape == jp.shape and tp.dtype == np.float32
    p = ks_2samp(tp[..., i].ravel(), jp[..., i].ravel()).pvalue
    assert p > P_MIN, p


@pytest.mark.parametrize("name", list(CFGS))
def test_n_signals_frequencies(draws, name):
    j, t = draws
    (_, jn), (_, tn) = j[name], t[name]
    assert tn.dtype == np.int32
    for k in range(CFGS[name].max_signals + 1):
        fj, ft = (jn == k).mean(), (tn == k).mean()
        p = 0.5 * (fj + ft)
        sigma = np.sqrt(max(p * (1 - p), 1e-12) * 2.0 / N_EVENTS)
        assert abs(ft - fj) <= N_SIGMA * sigma, (k, ft, fj)


def test_premerger_moves_single_signal_mergers_past_the_window():
    g = torch.Generator().manual_seed(1)
    cfg = tprior.PriorConfig(premerger_fraction=1.0)
    params, n_sig = tprior.sample_batch(512, cfg, g, "cpu")
    t0 = params[:, 0, tprior.IDX["geocent_time"]]
    single = n_sig == 1
    assert (t0[single] >= 2.5).all() and (t0[single] <= 5.0).all()
    assert (t0[~single] <= 1.5).all()
    d0 = params[single, 0, tprior.IDX["luminosity_distance"]]
    assert (d0 >= 50.0).all() and (d0 <= 400.0).all()


def test_loudness_matches_jax():
    from posteriflow_tpu.prior import loudness as jloud
    rng = np.random.default_rng(0)
    m = rng.uniform(1, 100, (2, 64)).astype(np.float32)
    d = rng.uniform(10, 2000, 64).astype(np.float32)
    np.testing.assert_allclose(
        tprior.loudness(*(torch.from_numpy(a) for a in (m[0], m[1], d))),
        np.asarray(jloud(m[0], m[1], d)), rtol=1e-6)
