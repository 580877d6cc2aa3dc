"""The hierarchical-bias corrector of the port against the JAX package on
the CPU: a JAX BiasCorrector.init tree carried across (the estimator's
outputs and `correct` on the same samples), and fit_synthetic learning the
injected stage-dependent bias as tests/test_evaluation.py:220-272 holds
the JAX one.

Tolerances: correction, sigma and vscale within 1e-5 of their largest
|value|, and the corrected samples within 1e-5 of each parameter's
largest |value| (float32 GEMM sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_overlap_helpers import one_torch_thread  # noqa: F401

from posteriflow_tpu.core.bias_corrector import BiasCorrector as JCorrector
from posteriflow_torch.core.bias_corrector import BiasCorrector
from posteriflow_torch.prior import sample_prior_bbh


def _samples(seed=1, n=800):
    rng = np.random.default_rng(seed)
    base = rng.multivariate_normal([30.0, 20.0], [[4.0, 1.8], [1.8, 1.0]], n)
    return np.column_stack(
        [base[:, 0], base[:, 1], rng.uniform(300, 900, n)]
        + [rng.uniform(0.1, 0.9, n) for _ in range(8)]).astype(np.float32)


def test_carried_weights_match_jax():
    jbc = JCorrector()
    jbc.params = jax.jit(lambda k: jbc.model.init(
        k, jnp.zeros((1, 11)), jnp.zeros((1, 4))))(jax.random.PRNGKey(3))
    bc = BiasCorrector.from_flax(jax.device_get(jbc.params), device="cpu")
    rng = np.random.default_rng(0)
    y = rng.uniform(-1, 1, (64, 11)).astype(np.float32)
    f = rng.uniform(0, 2, (64, 4)).astype(np.float32)
    ref = jbc.model.apply(jbc.params, jnp.asarray(y), jnp.asarray(f))
    with torch.no_grad():
        got = bc.model(torch.from_numpy(y), torch.from_numpy(f))
    for name, a, b in zip(("corr", "sigma", "vscale"), got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), name

    s = _samples()
    out = bc.correct(s, stage=2, quality=0.5, alpha=0.8, residual_ratio=0.7)
    j_out = jbc.correct(s, stage=2, quality=0.5, alpha=0.8,
                        residual_ratio=0.7)
    assert out["applied"] and j_out["applied"]
    scale = np.abs(j_out["samples"]).max(axis=0)
    assert (np.abs(out["samples"] - j_out["samples"]).max(axis=0)
            <= 1e-5 * scale).all()
    for k in ("mean_correction", "mean_vscale"):
        assert np.abs(out[k] - j_out[k]).max() <= 1e-5 * np.abs(
            j_out[k]).max(), k
    assert BiasCorrector(device="cpu").correct(s, 1, 0.5, 0.8, 0.7) == {
        "samples": s, "applied": False}


def test_fit_synthetic_learns_and_corrects():
    from posteriflow_torch.scaler import ParamScaler
    bc = BiasCorrector(device="cpu")
    loss = bc.fit_synthetic(np.random.default_rng(0), n_events=2048,
                            n_steps=300)
    assert np.isfinite(loss)
    rng = np.random.default_rng(9)
    theta = sample_prior_bbh(rng, 512)
    y_true = ParamScaler().normalize(torch.as_tensor(
        theta, dtype=torch.float32)).numpy()
    feats = np.stack([np.full(512, v, np.float32)
                      for v in (2.0, 0.5, 0.8, 0.7)], axis=1)
    amp = 0.03 * 2.0 * (1.2 - 0.5)
    y_est = y_true.copy()
    y_est[:, 0] -= amp
    y_est[:, 1] += amp
    y_est[:, 2] += 0.8 * amp
    rep = bc.validate(y_est, feats, y_true)
    assert rep["post_abs_bias"][0] < rep["pre_abs_bias"][0]
    assert rep["post_abs_bias"][2] < rep["pre_abs_bias"][2]
    assert 0.2 < float(np.median(rep["z_std"])) < 5.0

    samples = _samples()
    out = bc.correct(samples, stage=2, quality=0.5, alpha=0.8,
                     residual_ratio=0.7)
    s = out["samples"]
    assert out["applied"] and (s[:, 0] >= s[:, 1] - 1e-6).all()
    c_in = np.corrcoef(samples[:, 0], samples[:, 1])[0, 1]
    c_out = np.corrcoef(s[:, 0], s[:, 1])[0, 1]
    assert abs(c_in - c_out) < 0.25, (c_in, c_out)


def test_corrector_takes_its_size_from_the_scaler():
    """A 15-D (precessing) scaler gives a 15-D estimator; `correct` keeps
    the cloud's shape, stays finite and orders the masses."""
    from posteriflow_torch import PARAM_NAMES_PRECESSING
    from posteriflow_torch.scaler import ParamScaler
    bc = BiasCorrector(scaler=ParamScaler(PARAM_NAMES_PRECESSING),
                       device="cpu")
    bc.init(torch.Generator().manual_seed(3))
    assert bc.model.corr.out_features == len(PARAM_NAMES_PRECESSING)
    rng = np.random.default_rng(4)
    lo = bc.scaler.denormalize(torch.full((15,), -0.5)).numpy()
    hi = bc.scaler.denormalize(torch.full((15,), 0.5)).numpy()
    s = (lo + (hi - lo) * rng.random((64, 15))).astype(np.float32)
    out = bc.correct(s, stage=1, quality=0.5, alpha=0.8, residual_ratio=0.7)
    assert out["applied"] and out["samples"].shape == (64, 15)
    assert np.isfinite(out["samples"]).all()
    assert (out["samples"][:, 0] >= out["samples"][:, 1]).all()
