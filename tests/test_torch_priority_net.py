"""PriorityNet in the port against the JAX package on the CPU: the feature
functions, the released priority_v7 and priority_v5 nets carried across,
a small random net (flax init -> converter), the ranking loss and its
gradient in the weights, rank_uncertainty on JAX's normals, the order and
the loudness fallback. Every case has dead candidate slots.

Tolerances: features within 1e-6 of the largest |feature| (float32
rounding of the same formulas; the energy sums over 2048 samples are
added in another order); the nets' scores, sigma and aux within 1e-4 of
the largest live |score| plus 1e-5 (conv and GEMM sums in another order);
the loss within 1e-5 relative and each gradient leaf within 1e-4 of the
leaf's largest |entry| plus 1e-6 of the largest entry of any leaf (as
tests/test_torch_train_step.py allows: the attention key biases have a
gradient that is zero but for rounding); rank_uncertainty on the same
inputs and normals equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_overlap_helpers import (  # noqa: F401
    RELEASES, jax_release, one_torch_thread, port_release, scenario)

from posteriflow_tpu.models import priority_net as jpn
from posteriflow_torch.models import priority_net as tpn
from posteriflow_torch.train.train_priority import priority_flax_to_state_dict


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def test_feature_functions_match_jax():
    segs, params, mask, snr = scenario(1)
    j = [jpn.physics_features(jnp.asarray(params)),
         jpn.energy_features(jnp.asarray(segs)),
         jpn.pair_time_features(jnp.asarray(params), jnp.asarray(mask),
                                jnp.asarray(snr))]
    ts, tp, tm, tsn = _t(segs, params, mask, snr)
    t = [tpn.physics_features(tp), tpn.energy_features(ts),
         tpn.pair_time_features(tp, tm, tsn)]
    for name, a, b in zip(("physics", "energy", "pair_time"), t, j):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        assert _rel(a.numpy(), b) <= 1e-6, (name, _rel(a.numpy(), b))
    # the close pair of event 0 is inside the 0.25 s window; dead slots
    # see no neighbour and add no contamination
    pt = t[2].numpy()
    assert pt[0, 0, 1] >= 1.0 and pt[3, 0, 1] == 0.0 and pt[3, 0, 2] == 0.0


def _check_outputs(t_out, j_out, mask):
    live = mask > 0
    js = np.asarray(j_out[0])
    tol = 1e-4 * np.abs(js[live]).max() + 1e-5
    for name, a, b in zip(("score", "sigma", "aux"), t_out, j_out):
        a = a.detach().numpy()
        assert np.isfinite(a).all(), name
        assert np.abs(a - np.asarray(b)).max() <= tol, (
            name, np.abs(a - np.asarray(b)).max(), tol)
    assert (t_out[0].detach().numpy()[~live] == -1e9).all()


def _jax_apply(net, params, segs, cand, mask, snr):
    fn = jax.jit(lambda p, s, c, m, e: net.apply(p, s, c, m, with_aux=True,
                                                 snr_est=e))
    return fn(params, *(jnp.asarray(a) for a in (segs, cand, mask, snr)))


@pytest.mark.parametrize("name", RELEASES)
def test_released_net_matches_jax(name):
    segs, params, mask, snr = scenario(2)
    jnet, jp = jax_release(name)
    net = port_release(name)
    assert net.use_energy and net.use_snr_est
    assert net.use_dt == net.residual_snr == (name == "priority_v7")
    with torch.no_grad():
        t_out = net(*_t(segs, params, mask), with_aux=True,
                    snr_est=torch.from_numpy(snr))
    _check_outputs(t_out, _jax_apply(jnet, jp, segs, params, mask, snr),
                   mask)


SMALL_FLAGS = {"plain": {}, "v7": dict(use_energy=True, use_snr_est=True,
                                       use_dt=True, residual_snr=True)}


def _small_pair(flags, seed=0):
    """A flax PriorityNet (d_model 32) initialised by a jitted init and the
    port's net with the same weights."""
    segs, params, mask, snr = scenario(3)
    jnet = jpn.PriorityNet(d_model=32, **flags)
    jp = jax.jit(lambda k: jnet.init(
        k, jnp.asarray(segs), jnp.asarray(params), jnp.asarray(mask),
        with_aux=True, snr_est=jnp.asarray(snr)))(jax.random.PRNGKey(seed))
    # a non-zero priority head and calibration, so that they count
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 if any(getattr(k, "key", "") in (
            "priority_head", "cal_bias") for k in p) else x, jp)
    net = tpn.PriorityNet(d_model=32, **flags)
    net.load_state_dict(priority_flax_to_state_dict(
        jax.device_get(jp)), strict=True)
    return jnet, jp, net, (segs, params, mask, snr)


@pytest.mark.parametrize("flags", list(SMALL_FLAGS))
def test_random_net_matches_jax(flags):
    jnet, jp, net, (segs, params, mask, snr) = _small_pair(
        SMALL_FLAGS[flags])
    with torch.no_grad():
        t_out = net(*_t(segs, params, mask), with_aux=True,
                    snr_est=torch.from_numpy(snr))
    _check_outputs(t_out, _jax_apply(jnet, jp, segs, params, mask, snr),
                   mask)


def test_converter_raises_on_a_missing_or_extra_leaf():
    _, jp, net, _ = _small_pair(SMALL_FLAGS["v7"])
    sd = priority_flax_to_state_dict(jax.device_get(jp))
    with pytest.raises(RuntimeError):
        tpn.PriorityNet(d_model=32, use_energy=True, use_snr_est=True
                        ).load_state_dict(sd, strict=True)
    sd.pop("res_w")
    with pytest.raises(RuntimeError):
        net.load_state_dict(sd, strict=True)


def test_ranking_loss_and_gradient_match_jax():
    jnet, jp, net, (segs, params, mask, snr) = _small_pair(
        SMALL_FLAGS["v7"], seed=1)
    rng = np.random.default_rng(4)
    targets = (rng.uniform(0.2, 1.0, mask.shape) * mask).astype(np.float32)
    snr_true = (snr * rng.uniform(0.9, 1.1, mask.shape)).astype(np.float32)

    def jloss(p):
        sc, sg, aux = jnet.apply(p, jnp.asarray(segs), jnp.asarray(params),
                                 jnp.asarray(mask), with_aux=True,
                                 snr_est=jnp.asarray(snr))
        return jpn.ranking_loss(sc, jnp.asarray(targets), sg,
                                jnp.asarray(mask), aux=aux,
                                snr=jnp.asarray(snr_true), close_boost=2.0)

    j_loss, j_grad = jax.jit(jax.value_and_grad(jloss))(jp)
    sc, sg, aux = net(*_t(segs, params, mask), with_aux=True,
                      snr_est=torch.from_numpy(snr))
    tt, tm, tsn = _t(targets, mask, snr_true)
    loss = tpn.ranking_loss(sc, tt, sg, tm, aux=aux, snr=tsn,
                            close_boost=2.0)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    ref = priority_flax_to_state_dict(jax.device_get(j_grad))
    got = dict(net.named_parameters())
    assert set(ref) == set(got)
    top = max(float(g.abs().max()) for g in ref.values())
    for k, g in ref.items():
        err = float((got[k].grad - g).abs().max())
        assert err <= 1e-4 * float(g.abs().max()) + 1e-6 * top, (k, err)


def test_rank_uncertainty_with_jax_normals():
    segs, params, mask, snr = scenario(5)
    rng = np.random.default_rng(5)
    scores = np.where(mask > 0, rng.standard_normal(mask.shape),
                      -1e9).astype(np.float32)
    scores[0, 1] = scores[0, 0]                   # a tie
    sigma = rng.uniform(0.01, 0.5, mask.shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = np.asarray(jpn.rank_uncertainty(
        jnp.asarray(scores), jnp.asarray(sigma), jnp.asarray(mask), key,
        n_mc=64))
    eps = torch.from_numpy(np.asarray(jax.random.normal(key,
                                                        (64,) + mask.shape)))
    got = tpn.rank_uncertainty(*_t(scores, sigma, mask), eps=eps).numpy()
    np.testing.assert_array_equal(got, ref)
    drawn = tpn.rank_uncertainty(*_t(scores, sigma, mask), n_mc=64,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.shape == mask.shape and bool((drawn[~torch.from_numpy(
        mask > 0)] == 0).all())


def test_order_and_fallback_match_jax():
    _, params, mask, _ = scenario(7)
    rng = np.random.default_rng(7)
    scores = rng.standard_normal(mask.shape).astype(np.float32)
    scores[1, 0] = scores[1, 2]                   # a tie: the stable order
    ref = np.asarray(jpn.rank_by_score(jnp.asarray(scores),
                                       jnp.asarray(mask)))
    got = tpn.rank_by_score(*_t(scores, mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    fb = tpn.loudness_fallback(torch.from_numpy(params)).numpy()
    fb_ref = np.asarray(jpn.loudness_fallback(jnp.asarray(params)))
    assert _rel(fb, fb_ref) <= 1e-6
