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
from posteriflow_tpu.ops import rqs as jrqs
from posteriflow_torch.models.flow import CouplingNSF as TFlow
from posteriflow_torch.models.flow import make_permutations
from posteriflow_torch.ops import rqs as trqs
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


def _composed(tflow, v, ctx, inverse):
    """The flow composed as before the derivative bias moved into the
    spline call: raw = conditioner(...) with the bias added, then the plain
    spline on raw."""
    ld_total = torch.zeros(v.shape[:-1])
    layers = range(tflow.num_layers)
    for i in (reversed(layers) if inverse else layers):
        if not inverse:
            v = v[..., getattr(tflow, f"perm_{i}")]
        v_id, v_tr = v[..., :tflow.n_id], v[..., tflow.n_id:]
        raw = tflow._cond(i)(v_id, ctx)
        fn = trqs.rqs_inverse if inverse else trqs.rqs_forward
        out, ld = fn(v_tr, raw, tflow.num_bins, tflow.tail_bound)
        v = torch.cat([v_id, out], dim=-1)
        if inverse:
            v = v[..., getattr(tflow, f"inv_perm_{i}")]
        ld_total = ld_total + ld
    return v, ld_total


def test_bias_split_is_bit_for_bit_the_old_composition(flows):
    """Conditioner.project + bias= in the spline call gives the same bits
    as Conditioner.forward (projection + bias) fed to the spline: forward,
    log_prob, inverse and sampling."""
    _, _, _, tflow = flows
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.uniform(-1, 1, (B, D)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((B, C)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32))
    zctx = ctx[:, None, :]
    cond = tflow._cond(0)
    with torch.no_grad():
        assert torch.equal(cond(y[:, :tflow.n_id], ctx),
                           cond.project(y[:, :tflow.n_id], ctx)
                           + cond.deriv_bias)
        fz, fld = tflow.forward(y, ctx)
        cz, cld = _composed(tflow, y, ctx, inverse=False)
        assert torch.equal(fz, cz) and torch.equal(fld, cld)
        assert torch.equal(tflow.log_prob(y, ctx), tflow._log_base(cz) + cld)
        iy, ild = tflow.inverse(z, zctx)
        cy, cild = _composed(tflow, z, zctx, inverse=True)
        assert torch.equal(iy, cy) and torch.equal(ild, cild)
        sy, slq = tflow.sample_with_log_prob(z, zctx)
        assert torch.equal(sy, cy)
        assert torch.equal(slq, tflow._log_base(z) - cild)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_in_order_logdet_matches_jax(inverse):
    """The plain spline's logdet is the left-to-right sum of the per-dim
    terms, bit for bit (the order the CUDA kernel sums them in), and stays
    within the JAX rqs of tests/test_torch_rqs.py's tolerance: 1e-5 times
    the row's summed error gain, at the flagship's D = 7, K = 16."""
    k = 16
    rng = np.random.default_rng(6)
    x = np.clip(rng.standard_normal((3, 40, 7)) * 2.5, -6, 6).astype(
        np.float32)
    raw = (rng.standard_normal((3, 40, 7, 3 * k - 1)) * 0.7).astype(
        np.float32)
    t_fn = trqs.rqs_inverse if inverse else trqs.rqs_forward
    j_fn = jrqs.rqs_inverse if inverse else jrqs.rqs_forward
    xt, rt = torch.from_numpy(x), torch.from_numpy(raw)
    _, ld = t_fn(xt, rt, k)
    terms = [t_fn(xt[..., j:j + 1], rt[..., j:j + 1, :], k)[1]
             for j in range(7)]
    in_order = terms[0]
    for t in terms[1:]:
        in_order = in_order + t
    assert torch.equal(ld, in_order)
    _, jld = j_fn(jnp.asarray(x), jnp.asarray(raw), k)
    _, gld = j_fn(jnp.asarray(x.reshape(-1, 1)),
                  jnp.asarray(raw.reshape(-1, 1, 3 * k - 1)), k)
    g = np.exp(np.asarray(gld)).reshape(x.shape)
    gain = (1.0 + np.maximum(g, 1.0 / g)).sum(-1)
    err = np.abs(ld.numpy().astype(np.float64) - np.asarray(jld, np.float64))
    assert float(np.max(err / gain)) <= 1e-5
