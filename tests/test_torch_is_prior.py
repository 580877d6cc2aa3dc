"""The closed-form BBH prior and the anchor's host pieces against the JAX
package: log_prior_bbh (11-D and 15-D, inside and outside the support,
both distance priors), sample_prior_bbh, the nested sampler's
prior_transform and built-in fallback, align_conventions and
ComparisonMetrics.

Tolerances: log_prior_bbh -inf in the same entries and within 1e-5
relative elsewhere (both in float32); sample_prior_bbh, prior_transform,
align_conventions and _nested_fallback (on the same numpy likelihood) bit
for bit; ComparisonMetrics to 1e-12 relative (the same numpy and scipy
calls)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.evaluation.metrics import ComparisonMetrics as JCM
from posteriflow_tpu.inference import dynesty_bridge as jdb
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.prior import log_prior_bbh as jlog_prior
from posteriflow_tpu.prior import sample_prior_bbh as jsample_prior
from posteriflow_torch.evaluation.metrics import ComparisonMetrics as TCM
from posteriflow_torch.inference import dynesty_bridge as tdb
from posteriflow_torch.prior import PriorConfig as TPrior
from posteriflow_torch.prior import log_prior_bbh as tlog_prior
from posteriflow_torch.prior import sample_prior_bbh as tsample_prior


def _thetas(n_params: int, seed: int) -> np.ndarray:
    """Prior draws, then rows pushed out of the support one bound at a
    time (below and above each box, m2 > m1) and rows on bounds."""
    rng = np.random.default_rng(seed)
    base = jsample_prior(rng, 64, JPrior(precessing=n_params == 15))
    rows = [base]
    lo_hi = {0: (4.9, 101.0), 1: (4.9, None), 2: (49.0, 2001.0),
             3: (-0.1, 2 * math.pi + 0.1), 4: (-1.6, 1.6), 5: (-0.1, 3.2),
             6: (-0.1, 3.2), 7: (-0.1, 6.4), 8: (-1.6, 1.6), 9: (-0.1, 1.0),
             10: (-0.1, 1.0)}
    if n_params == 15:
        lo_hi.update({11: (-0.1, 3.2), 12: (-0.1, 3.2), 13: (-0.1, 6.4),
                      14: (-0.1, 6.4)})
    for col, (lo, hi) in lo_hi.items():
        for v in (lo, hi):
            if v is not None:
                r = base[:2].copy()
                r[:, col] = v
                rows.append(r)
    swapped = base[:2].copy()
    swapped[:, 1] = swapped[:, 0] + 1.0                 # m2 > m1
    on_bound = base[:2].copy()
    on_bound[:, 0], on_bound[:, 1], on_bound[:, 2] = 100.0, 5.0, 2000.0
    rows += [swapped, on_bound]
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("n_params", [11, 15])
@pytest.mark.parametrize("distance", ["comoving_d2", "uniform"])
def test_log_prior_bbh_matches_jax(n_params, distance):
    theta = _thetas(n_params, seed=n_params)
    ref = np.asarray(jax.vmap(lambda t: jlog_prior(
        t, JPrior(distance_prior=distance)))(jnp.asarray(theta)))
    got = tlog_prior(torch.from_numpy(theta),
                     TPrior(distance_prior=distance)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isneginf(ref).sum() >= 20 and np.isfinite(ref).sum() >= 64
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5)


@pytest.mark.parametrize("precessing", [False, True])
@pytest.mark.parametrize("distance", ["comoving_d2", "uniform"])
def test_sample_prior_bbh_is_bit_equal(precessing, distance):
    a = jsample_prior(np.random.default_rng(3), 500,
                      JPrior(precessing=precessing, distance_prior=distance))
    b = tsample_prior(np.random.default_rng(3), 500,
                      TPrior(precessing=precessing, distance_prior=distance))
    assert b.shape == (500, 15 if precessing else 11)
    np.testing.assert_array_equal(a, b)
    lp = tlog_prior(torch.from_numpy(b.astype(np.float32)),
                    TPrior(distance_prior=distance))
    assert bool(torch.isfinite(lp).all())       # draws lie in the support


@pytest.mark.parametrize("ndim", [11, 15])
def test_prior_transform_and_conventions_bit_equal(ndim):
    u = np.random.default_rng(ndim).uniform(size=(300, ndim))
    np.testing.assert_array_equal(tdb.prior_transform(u),
                                  jdb.prior_transform(u))
    assert tdb.training_matched_priors() == jdb.training_matched_priors()
    th = tdb.prior_transform(u)
    for to_abs in (True, False):
        np.testing.assert_array_equal(
            tdb.align_conventions(th, to_abs),
            jdb.align_conventions(th, to_abs))


def _gauss_log_l(t):
    t = np.asarray(t, np.float64)
    return (-0.5 * ((t[:, 0] - 35.0) / 3.0) ** 2
            - 0.5 * ((t[:, 2] - 900.0) / 150.0) ** 2)


@pytest.mark.parametrize("ndim", [11, 15])
def test_nested_fallback_is_bit_equal(ndim):
    kw = dict(nlive=160, dlogz=0.5, seed=4, maxiter=600, ndim=ndim,
              walks=6)
    a = jdb._nested_fallback(_gauss_log_l, **kw)
    b = tdb.run_dynesty(_gauss_log_l, **kw)      # dynesty is not installed
    assert b["sampler"] == a["sampler"] == "fallback-nested"
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert np.isfinite(b["logz"]) and b["samples"].shape[1] == ndim


def test_comparison_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(400, 11)) * 2.0 + 1.0
    b = rng.normal(size=(300, 11))
    ra = JCM().compare_posteriors(a, b)
    rb = TCM().compare_posteriors(a, b)
    assert ra.keys() == rb.keys()
    for name in ra:
        assert ra[name].keys() == rb[name].keys()
        for k in ra[name]:
            assert rb[name][k] == pytest.approx(ra[name][k], rel=1e-12)
    sa, sb = JCM.summarize(ra), TCM.summarize(rb)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sb[k] == pytest.approx(sa[k], rel=1e-12)
