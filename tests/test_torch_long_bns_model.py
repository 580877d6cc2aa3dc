"""The long-BNS models of the port against the JAX package with the same
weights: LongBNSEncoder and LongBNSNPEv4 at a small size (d_model 32, one
layer, 4 heads, 2 flow layers, K = 12) with every weight drawn at random,
the full-width long_bns_v4 release on the same tokens, and long_bns_v1's
NLL."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import from_bytes

from posteriflow_tpu.models import long_bns as jlb
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.train.checkpoints import load_long_bns
from torch_long_bns_helpers import (SMALL_ENC, SMALL_FLOW, TEST_TOKENS,
                                    V1_RELEASE, V4_RELEASE, carry_params)
from torch_sim_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _batch(grid, b, seed):
    """A port-simulated v4 batch (tokens, θ, trig) as numpy."""
    gen = torch.Generator().manual_seed(seed)
    return [a.numpy() for a in tlb.simulate_long_bns_batch_v4(
        b, grid, generator=gen, device="cpu")]


def _randomize(params, seed, scale=0.2):
    """Every leaf of a flax tree drawn N(0, scale²) (LayerNorm scales
    around 1), so that no layer is the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        v = rng.standard_normal(a.shape) * scale
        if path[-1].key == "scale":
            v = 1.0 + v
        return jnp.asarray(v.astype(a.dtype))
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def small():
    """The small v4 model in both packages with the same random weights,
    on the JAX tests' grid (16 s: 160 tokens, 40 patches)."""
    grid = tlb.build_trigger_token_grid(**TEST_TOKENS)
    tokens, theta, trig = _batch(grid, 3, seed=1)
    kw = dict(sigma_mc_rel=grid["sigma_mc_rel"], sigma_t=grid["sigma_t"])
    jm = jlb.LongBNSNPEv4(enc=SMALL_ENC, **SMALL_FLOW, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), tokens, theta, trig)
    params = _randomize(params, seed=2)
    tm = tlb.LongBNSNPEv4(enc=SMALL_ENC, **SMALL_FLOW, **kw)
    tm.load_state_dict(carry_params(params), strict=True)
    return jm, params, tm, (tokens, theta, trig)


def test_small_encoder(small):
    """LongBNSEncoder with random weights: the context within 1e-5 of its
    largest |entry| (float32 matmuls, TF32 off, summed in another order),
    and the trigger-joined context likewise."""
    jm, params, tm, (tokens, _, trig) = small
    jctx = np.asarray(jax.jit(lambda p, t, tr: jm.apply(
        p, t, tr, method=lambda m, t, tr: m._context(t, tr)))(
            params, tokens, trig))
    with torch.no_grad():
        tctx = tm.context(torch.from_numpy(tokens),
                          torch.from_numpy(trig)).numpy()
    assert tctx.shape == (3, 16 + 5)
    np.testing.assert_allclose(tctx, jctx, atol=1e-5 * np.abs(jctx).max())


def test_small_nll_and_samples(small):
    """LongBNSNPEv4 at K = 12 with random weights against JAX run op by op
    (the port rounds the bfloat16 conditioner after each operation as JAX
    does eagerly; a jitted JAX program fuses them and differs by ~3e-3
    nats): the mean NLL within 1e-4 nats (measured 4e-6), and sample_raw
    from the same base draws z: the raw draws y within 1e-4 (measured
    8e-6) and the physical draws within 1e-4 relative plus 1e-3."""
    jm, params, tm, (tokens, theta, trig) = small
    jn = float(jm.apply(params, tokens, theta, trig))
    with torch.no_grad():
        tn = float(tm(*(torch.from_numpy(a) for a in (tokens, theta, trig))))
    assert abs(tn - jn) <= 1e-4, (tn, jn)
    z = np.random.default_rng(3).standard_normal((3, 32, 11)).astype(
        np.float32)

    def j_sample(p, t, tr, z):
        def f(m):
            ctx = m._context(t, tr)
            y, _ = m.flow.sample_with_log_prob(z, ctx[:, None, :])
            return m.scaler.denormalize(y, tr[:, None, :]), y
        return jm.apply(p, method=f)
    jd, jy = (np.asarray(a) for a in j_sample(params, tokens, trig, z))
    with torch.no_grad():
        td, ty = (a.numpy() for a in tm.sample_raw(
            torch.from_numpy(tokens), torch.from_numpy(trig),
            z=torch.from_numpy(z)))
    assert td.shape == (3, 32, 11)
    np.testing.assert_allclose(ty, jy, atol=1e-4)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-3)


def _jax_release(jm, release, *sample):
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *sample)
    return from_bytes(params, (release / "params.msgpack").read_bytes())


@pytest.fixture(scope="module")
def release_v4():
    tm, cal, grid = load_long_bns(V4_RELEASE, device="cpu")
    tok = cal["tokens"]
    jm = jlb.LongBNSNPEv4(enc=cal["enc"], flow_bins=cal["flow"]["bins"],
                          sigma_mc_rel=tok["sigma_mc_rel"],
                          sigma_t=tok["sigma_t"])
    batch = _batch(grid, 4, seed=4)
    return jm, _jax_release(jm, V4_RELEASE, *batch), tm, cal, batch


def test_release_v4_loads_whole(release_v4):
    """long_bns_v4 from its params.msgpack and calibration.json: K = 12,
    1,009,818 parameters in both packages (meta.json's count), every leaf
    carried."""
    jm, params, tm, cal, _ = release_v4
    meta = json.loads((V4_RELEASE / "meta.json").read_text())
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_jax == n_port == meta["config"]["n_params"] == 1_009_818
    assert tm.flow.num_bins == 12 and tm.flow.num_layers == 6
    assert len(jax.tree_util.tree_leaves(params)) == len(tm.state_dict())


def test_release_v4_on_same_tokens(release_v4):
    """The released model in both packages on the same 4 simulated events,
    JAX run op by op: the context within 1e-5 of its largest |entry|;
    log q on the same labels (JAX's) within 1e-3 nats (measured 2e-5);
    the mean NLL through each package's own labels within 0.1 nats
    (measured 9e-5 here; the trigger-relative y_mc divides the chirp mass
    by 2.5e-3, so where JAX's float32 pow rounds it a step the other way
    a trained density moves by up to a tenth of a nat: 0.034 on the mean
    of 4 other events); sample_raw from the same z: y within 1e-2
    (measured 1e-3: the six bfloat16 conditioners of the inverse carry
    the rounding of the context's last bits) and the draws within 1e-2
    relative."""
    jm, params, tm, _, (tokens, theta, trig) = release_v4
    t = [torch.from_numpy(a) for a in (tokens, theta, trig)]
    ctx_fn = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, method=lambda m, a, b: m._context(a, b)))
    jctx = np.asarray(ctx_fn(params, tokens, trig))
    with torch.no_grad():
        tctx = tm.context(t[0], t[2]).numpy()
    np.testing.assert_allclose(tctx, jctx, atol=1e-5 * np.abs(jctx).max())

    jy = np.asarray(jm.apply(params, theta, trig,
                             method=lambda m, a, b: m.scaler.normalize(a, b)))
    jlq = np.asarray(jm.apply(params, jy, jctx,
                              method=lambda m, y, c: m.flow.log_prob(y, c)))
    with torch.no_grad():
        tlq = tm.flow.log_prob(torch.from_numpy(jy),
                               torch.from_numpy(jctx)).numpy()
        tn = float(tm(*t))
    np.testing.assert_allclose(tlq, jlq, atol=1e-3)
    jn = float(jm.apply(params, tokens, theta, trig))
    assert abs(tn - jn) <= 0.1, (tn, jn)

    z = np.random.default_rng(5).standard_normal((4, 16, 11)).astype(
        np.float32)

    def j_sample(p, c, tr, z):
        def f(m):
            y, _ = m.flow.sample_with_log_prob(z, c[:, None, :])
            return m.scaler.denormalize(y, tr[:, None, :]), y
        return jm.apply(p, method=f)
    jd, jys = (np.asarray(a) for a in j_sample(params, jctx, trig, z))
    with torch.no_grad():
        td, tys = (a.numpy() for a in tm.sample_raw(t[0], t[2],
                                                    z=torch.from_numpy(z)))
    np.testing.assert_allclose(tys, jys, atol=1e-2)
    np.testing.assert_allclose(td, jd, rtol=1e-2, atol=1e-2)


def test_release_v1_nll():
    """long_bns_v1 (no meta.json; K = 8, 2048 tokens of 6 channels, 954,674
    parameters as its calibration.json records) in both packages on the
    same 2 simulated events: the context within 1e-5 of its largest
    |entry| and the mean NLL within 1e-2 nats (bfloat16 conditioner)."""
    tm, cal, grid = load_long_bns(V1_RELEASE, device="cpu")
    assert grid is None and tm.flow.num_bins == 8
    assert sum(p.numel() for p in tm.parameters()) == cal["n_params"]
    gen = torch.Generator().manual_seed(6)
    tokens, theta = (a.numpy() for a in tlb.simulate_long_bns_batch(
        2, generator=gen, device="cpu"))
    assert tokens.shape == (2, 2048, 6)
    jm = jlb.LongBNSNPE(enc={k: cal[k] for k in ("d_model", "n_layers")})
    params = _jax_release(jm, V1_RELEASE, tokens, theta)
    jctx = np.asarray(jax.jit(lambda p, a: jm.apply(
        p, a, method=lambda m, a: jax.vmap(lambda x: m.encoder(
            x, jlb.sinusoidal_positions(a.shape[1], 128)))(a)))(
                params, tokens))
    jn = float(jm.apply(params, tokens, theta))
    with torch.no_grad():
        tctx = tm.encoder(torch.from_numpy(tokens)).numpy()
        tn = float(tm(torch.from_numpy(tokens), torch.from_numpy(theta)))
    np.testing.assert_allclose(tctx, jctx, atol=1e-5 * np.abs(jctx).max())
    assert abs(tn - jn) <= 1e-2, (tn, jn)
