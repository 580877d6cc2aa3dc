"""posteriflow_torch.models.flow.CouplingNSF against the flax CouplingNSF of
posteriflow_tpu at D = 15, 2 layers, hidden 32, K = 4, with the JAX
parameters (moved off their zero init with numpy) carried into the port by
train.checkpoints.flax_to_state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models.flow import CouplingNSF as JFlow
from posteriflow_tpu.models.flow import _make_permutations
from posteriflow_torch.models.flow import CouplingNSF as TFlow
from posteriflow_torch.models.flow import make_permutations
from posteriflow_torch.train.checkpoints import flax_to_state_dict

D, C, LAYERS, HIDDEN, K = 15, 12, 2, 32, 4
B, N = 3, 50
# float32: the same arithmetic, rounding apart; bfloat16: a hidden
# activation that rounds to the neighbouring bf16 value (step 2^-8) moves
# the spline parameters, so the tolerance is set by bf16, not by the spline
TOL = {"float32": dict(x=1e-4, ld=1e-3), "bfloat16": dict(x=2e-2, ld=1e-1)}


def _perturbed(params, seed=0, scale=0.1):
    """Every leaf plus N(0, scale²). At 0.1 the splines have slopes up to a
    few tens; at 0.3 some reach ~1e3 and float32 forward∘inverse loses its
    accuracy in both packages alike."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape)
        .astype(np.float32), params)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def flows(request):
    dt = request.param
    jflow = JFlow(features=D, context_features=C, num_layers=LAYERS,
                  hidden=HIDDEN, num_bins=K, compute_dtype=dt)
    rng = np.random.default_rng(1)
    y0 = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    c0 = rng.standard_normal((B, C)).astype(np.float32)
    params = _perturbed(jax.device_get(
        jflow.init(jax.random.PRNGKey(0), jnp.asarray(y0), jnp.asarray(c0))))
    tflow = TFlow(features=D, context_features=C, num_layers=LAYERS,
                  hidden=HIDDEN, num_bins=K, compute_dtype=dt)
    tflow.load_state_dict(flax_to_state_dict(params), strict=True)
    return dt, jflow, params, tflow.eval()


def test_permutations_match():
    np.testing.assert_array_equal(make_permutations(15, 10),
                                  _make_permutations(15, 10))


def test_forward_and_log_prob(flows):
    dt, jflow, params, tflow = flows
    rng = np.random.default_rng(2)
    y = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    ctx = rng.standard_normal((B, C)).astype(np.float32)
    jz, jld = jflow.apply(params, jnp.asarray(y), jnp.asarray(ctx),
                          method=JFlow.forward)
    jlp = jflow.apply(params, jnp.asarray(y), jnp.asarray(ctx))
    with torch.no_grad():
        tz, tld = tflow.forward(torch.from_numpy(y), torch.from_numpy(ctx))
        tlp = tflow.log_prob(torch.from_numpy(y), torch.from_numpy(ctx))
    assert float(np.abs(np.asarray(jld)).max()) > 0.1   # not the identity
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=TOL[dt]["x"])
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld),
                               atol=TOL[dt]["ld"])
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp),
                               atol=TOL[dt]["ld"])


def test_inverse_sampling_with_broadcast_context(flows):
    """Sampling shape: z [B, n, D] against context [B, 1, C]."""
    dt, jflow, params, tflow = flows
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, N, D)).astype(np.float32)
    ctx = rng.standard_normal((B, 1, C)).astype(np.float32)
    jy, jlq = jflow.apply(params, jnp.asarray(z), jnp.asarray(ctx),
                          method=JFlow.sample_with_log_prob)
    with torch.no_grad():
        ty, tlq = tflow.sample_with_log_prob(torch.from_numpy(z),
                                             torch.from_numpy(ctx))
    assert tuple(ty.shape) == (B, N, D) and tuple(tlq.shape) == (B, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL[dt]["x"])
    np.testing.assert_allclose(tlq.numpy(), np.asarray(jlq),
                               atol=TOL[dt]["ld"])


def test_port_roundtrip(flows):
    """forward∘inverse of the port is the identity (f32 spline solve)."""
    dt, _, _, tflow = flows
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.uniform(-1, 1, (B, D)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    with torch.no_grad():
        z, ld = tflow.forward(y, ctx)
        y2, ld2 = tflow.inverse(z, ctx)
    np.testing.assert_allclose(y2.numpy(), y.numpy(), atol=1e-4)
    np.testing.assert_allclose((ld + ld2).numpy(), 0.0, atol=1e-3)
