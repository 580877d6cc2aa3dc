"""posteriflow_torch.models.npe.LeanNPE against the flax LeanNPE of
posteriflow_tpu on a narrow 15-D coherent model (d_model 32, 1 encoder
layer, 2 flow layers of hidden 32, K = 4): encode, nll_from_context and
sample_from_context fed the base draws that JAX draws from its key, in
float32 and in bfloat16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu import PARAM_NAMES_PRECESSING
from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.models.npe import NPEConfig as JCfg
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.models.npe import NPEConfig as TCfg
from posteriflow_torch.train.checkpoints import flax_to_state_dict

B, N = 2, 64
SMALL = dict(param_names=PARAM_NAMES_PRECESSING, context_dim=24, rank_dim=8,
             flow_layers=2, flow_hidden=32, flow_bins=4, d_model=32,
             enc_layers=1, enc_heads=4, psd_cond=True)
# (context rel., y and theta rel., log q / nll abs.): float32 differs by
# rounding order only; in bfloat16 an activation may round to the
# neighbouring bf16 value (step 2^-8) in one package and not the other
TOL = {"float32": (2e-4, 1e-4, 1e-3), "bfloat16": (3e-2, 2e-2, 1e-1)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    strain = rng.standard_normal((B, 3, 16384)).astype(np.float32)
    bands = (0.1 * rng.standard_normal((B, 3, 16))).astype(np.float32)
    return strain, bands


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = JCfg(encoder_dtype=dt, flow_dtype=dt, **SMALL)
    jm = JNPE(jcfg)
    strain, bands = _inputs()
    theta = jnp.full((B, len(PARAM_NAMES_PRECESSING)), 1.5, jnp.float32)
    params = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.asarray(strain), theta,
        jnp.zeros(B, jnp.int32), jnp.asarray(bands)))
    # the flow's output layers start at zero (identity flow): move every flow
    # leaf off its init so the comparison is not of two identities
    rng = np.random.default_rng(1)
    params["params"]["flow"] = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        params["params"]["flow"])
    tm = TNPE(TCfg(encoder_dtype=dt, flow_dtype=dt, **SMALL))
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return dt, jm, params, tm.eval()


def test_encode(models):
    dt, jm, params, tm = models
    strain, bands = _inputs(seed=2)
    j = np.asarray(jm.apply(params, jnp.asarray(strain), jnp.asarray(bands),
                            method=JNPE.encode))
    with torch.no_grad():
        t = tm.encode(torch.from_numpy(strain), torch.from_numpy(bands))
    tol = TOL[dt][0] * max(1.0, np.abs(j).max())
    np.testing.assert_allclose(t.numpy(), j, atol=tol)


def test_nll_from_context(models):
    """Same context into both: the scaler, rank embedding and flow density."""
    dt, jm, params, tm = models
    rng = np.random.default_rng(3)
    ctx = rng.standard_normal((B, SMALL["context_dim"])).astype(np.float32)
    y = rng.uniform(-0.9, 0.9, (B, 15)).astype(np.float32)
    rank = np.array([0, 1])
    theta = np.array(jm.apply(params, jnp.asarray(y),
                              method=lambda m, v: m.scaler.denormalize(v)))
    j = np.asarray(jm.apply(params, jnp.asarray(ctx), jnp.asarray(theta),
                            jnp.asarray(rank), method=JNPE.nll_from_context))
    with torch.no_grad():
        t = tm.nll_from_context(torch.from_numpy(ctx),
                                torch.from_numpy(theta),
                                torch.from_numpy(rank)).numpy()
    np.testing.assert_allclose(t, j, atol=TOL[dt][2])


def test_sample_from_context_with_jax_draws(models):
    """The port is fed the base draws JAX takes from its key."""
    dt, jm, params, tm = models
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((B, SMALL["context_dim"])).astype(np.float32)
    rank = np.array([1, 0])
    key = jax.random.PRNGKey(5)
    jt, jy, jlq = (np.asarray(a) for a in jm.apply(
        params, key, jnp.asarray(ctx), jnp.asarray(rank), N,
        method=JNPE.sample_from_context))
    z = np.array(jax.random.normal(key, (B, N, 15)))
    with torch.no_grad():
        tt, ty, tlq = (a.numpy() for a in tm.sample_from_context(
            torch.from_numpy(ctx), torch.from_numpy(rank), N,
            z=torch.from_numpy(z)))
    _, tol_x, tol_lq = TOL[dt]
    assert tt.shape == (B, N, 15) and np.isfinite(tt).all()
    np.testing.assert_allclose(ty, jy, atol=tol_x)
    np.testing.assert_allclose(tt, jt, rtol=tol_x, atol=tol_x)
    np.testing.assert_allclose(tlq, jlq, atol=tol_lq)


def test_sample_uses_generator():
    """Without z the draws come from the given generator: same seed, same
    samples."""
    tm = TNPE(dataclasses.replace(TCfg(**SMALL), flow_dtype="float32",
                                  encoder_dtype="float32")).eval()
    ctx = torch.zeros(1, SMALL["context_dim"])
    rank = torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        a = tm.sample_from_context(ctx, rank, 8,
                                   generator=torch.Generator().manual_seed(3))
        b = tm.sample_from_context(ctx, rank, 8,
                                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and a[0].shape == (1, 8, 15)
