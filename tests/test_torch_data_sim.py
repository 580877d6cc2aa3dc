"""The port's simulator with real noise against the JAX package's on the
CPU: simulate_batch with a noise bank (every event real, and a mix) and
with a host feed's crops, and simulate_event with a bank, given JAX's own
prior, event and real-noise draws (rebuilt from its keys by
tests/torch_sim_helpers.py); and the Gaussian stream unchanged by a bank
at real_noise_prob 0.

Tolerances (those of tests/test_torch_sim_event.py): the gate, the
parameters, det_mask and asd_bands exact; per-signal SNRs within 1e-5
relative, the network SNR within 1e-4; the strain within 1e-4 plus 2e-3 of
the peak of the event's re-coloured whitened signal (the two packages'
float32 waveform phases differ by that much). The crops themselves are
exact, so the noise adds nothing to the error.
"""

import jax
import numpy as np
import pytest
import torch

from posteriflow_tpu.data import noise_bank as jbank
from posteriflow_tpu.physics import simulator as jsim
from posteriflow_tpu.physics.psd import default_network_asd as jasd
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.prior import sample_batch as jsample_batch
from posteriflow_torch.data import noise_bank as tbank
from posteriflow_torch.physics import simulator as tsim
from posteriflow_torch.physics.constants import N_RFFT, N_SAMPLES
from posteriflow_torch.physics.psd import default_network_asd as tasd
from torch_sim_helpers import (draws_array, jax_batch_inputs,
                               jax_batch_real_draws, jax_event_draws,
                               jax_real_draws, one_torch_thread,
                               port_sim_config)

STRAIN_ATOL, SIG_RTOL, SNR_RTOL, NET_SNR_RTOL = 1e-4, 2e-3, 1e-5, 1e-4
CFGS = {
    "aligned": jsim.SimConfig(prior=JPrior(max_signals=3), det_dropout=0.5,
                              glitch_prob=0.5, real_noise_prob=1.0),
    "precessing_mix": jsim.SimConfig(
        prior=JPrior(max_signals=2, precessing=True), det_dropout=0.5,
        glitch_prob=0.5, real_noise_prob=0.5),
}
FEED = "aligned"
EVENT_CFG = jsim.SimConfig(prior=JPrior(max_signals=3, precessing=True),
                           det_dropout=1.0, glitch_prob=1.0,
                           real_noise_prob=1.0)
KEYS = {"aligned": 21, "precessing_mix": 28, "feed": 23, "event": 25}
B = 4


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(0)
    for det in ("H1", "L1", "V1"):
        for gps in (1262000000, 1262004096):
            tbank.save_bank_segment(
                d, det, gps, rng.standard_normal(N_SAMPLES + 4096),
                4e-24 * np.exp(rng.normal(0, 0.3, N_RFFT)))
    return d


def _feed_arrays():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((B, 3, N_SAMPLES)).astype(np.float32),
            np.exp(rng.normal(0, 0.3, (B, 3, N_RFFT))).astype(np.float32),
            rng.normal(0, 0.1, (B, 3, 16)).astype(np.float32))


@jax.jit
def _jax_all(bank, feed, ev_params, asd):
    out = {}
    for name, cfg in CFGS.items():
        key = jax.random.PRNGKey(KEYS[name])
        out[name] = jsim.simulate_batch(key, B, cfg, bank=bank)
        out[name + "_prior"] = jsample_batch(jax.random.split(key)[0], B,
                                             cfg.prior)
    key = jax.random.PRNGKey(KEYS["feed"])
    out["feed"] = jsim.simulate_batch(key, B, CFGS[FEED], real_feed=feed)
    out["feed_prior"] = jsample_batch(jax.random.split(key)[0], B,
                                      CFGS[FEED].prior)
    out["event"] = jsim.simulate_event(jax.random.PRNGKey(KEYS["event"]),
                                       ev_params, 3, asd, EVENT_CFG,
                                       bank=bank)
    return out


@pytest.fixture(scope="module")
def runs(bank_dir):
    jb = jbank.load_noise_bank(bank_dir)
    tb = tbank.load_noise_bank(bank_dir, device="cpu")
    feed = _feed_arrays()
    ev = draws_array(15)[[0, 2, 1]]
    out = _jax_all(jb, feed, ev, jasd())
    return jax.tree_util.tree_map(np.asarray, out), tb, feed, ev


def _hold(t, j, draws, real, cfg):
    """The gate, masks and bands exact; SNRs; the strain within 1e-4 plus
    2e-3 of the peak of JAX's whitened signal (its strain less the noise
    the event took, real or Gaussian, and the glitch, on kept detectors)."""
    np.testing.assert_array_equal(t.n_sig.numpy(), j.n_sig)
    np.testing.assert_array_equal(t.det_mask.numpy(), j.det_mask)
    np.testing.assert_array_equal(t.params.numpy(), j.params)
    np.testing.assert_array_equal(t.asd_bands.numpy(), j.asd_bands)
    np.testing.assert_allclose(t.sig_snr.numpy(), j.sig_snr, rtol=SNR_RTOL)
    np.testing.assert_allclose(t.net_snr.numpy(), j.net_snr,
                               rtol=NET_SNR_RTOL)
    use = (real.use_u < cfg.real_noise_prob).numpy()[..., None, None]
    noise = np.where(use, real.noise.numpy(), draws.noise.numpy())
    if cfg.glitch_prob > 0:
        noise = noise + tsim._glitch_burst(draws, cfg.glitch_prob).numpy()
    sig = np.where(j.det_mask[..., None] > 0, j.strain - noise, 0.0)
    tol = STRAIN_ATOL + SIG_RTOL * np.abs(sig).max(axis=(-2, -1))
    err = np.abs(t.strain.numpy() - j.strain).max(axis=(-2, -1))
    assert (err <= tol).all(), (err, tol)
    # a dropped detector shows the crop flipped and negated, or Gaussian fill
    fill = np.where(use, -real.noise.numpy()[..., ::-1], draws.fill.numpy())
    dropped = j.det_mask[..., None] == 0
    np.testing.assert_array_equal(np.where(dropped, t.strain.numpy(), 0),
                                  np.where(dropped, fill, 0))
    return use


@pytest.mark.parametrize("name", list(CFGS))
def test_simulate_batch_with_bank(runs, name):
    j, tb, _, _ = runs
    cfg = CFGS[name]
    key = jax.random.PRNGKey(KEYS[name])
    _, _, draws = jax_batch_inputs(key, B, cfg)
    real_draws = jax_batch_real_draws(key, B, tb.n_segments, tb.segment_len)
    params, n_sig = (torch.from_numpy(a.copy()) for a in j[name + "_prior"])
    tcfg = port_sim_config(cfg)
    t = tsim.simulate_batch(B, tcfg, device="cpu", params=params,
                            n_sig=n_sig, draws=draws, bank=tb,
                            real_draws=real_draws)
    real = tsim.real_noise(real_draws, tb)
    use = _hold(t, j[name], draws, real, tcfg)
    if cfg.real_noise_prob == 1.0:
        assert use.all()
    else:                                   # the key was picked for a mix
        assert use.any() and not use.all()
    kept = t.det_mask.numpy() > 0
    live = np.abs(t.asd_bands.numpy()).max(-1)
    assert (live[kept & use[..., 0, 0][:, None]] > 0).all()
    assert (live[~kept] == 0).all()
    assert (live[~use[..., 0, 0]] == 0).all()
    assert (t.det_mask.numpy() == 0).any()


def test_simulate_batch_with_feed(runs):
    j, _, feed, _ = runs
    cfg = CFGS[FEED]
    key = jax.random.PRNGKey(KEYS["feed"])
    _, _, draws = jax_batch_inputs(key, B, cfg)
    use_u = jax_batch_real_draws(key, B, 2, 2 * N_SAMPLES).use_u
    params, n_sig = (torch.from_numpy(a.copy()) for a in j["feed_prior"])
    real_feed = tuple(torch.from_numpy(a) for a in feed)
    tcfg = port_sim_config(cfg)
    t = tsim.simulate_batch(B, tcfg, device="cpu", params=params,
                            n_sig=n_sig, draws=draws, real_feed=real_feed,
                            real_draws=tsim.RealDraws(use_u, None))
    _hold(t, j["feed"], draws, tsim.RealNoise(use_u, *real_feed), tcfg)


def test_simulate_event_with_bank(runs):
    """simulate_event without `pre`, every detector but one dropped
    (dropout 1), a glitch, real noise."""
    j, tb, _, ev = runs
    key = jax.random.PRNGKey(KEYS["event"])
    draws = jax_event_draws(key)
    real_draws = jax_real_draws(key, tb.n_segments, tb.segment_len)
    tcfg = port_sim_config(EVENT_CFG)
    t = tsim.simulate_event(torch.from_numpy(ev), 3, tasd(device="cpu"),
                            tcfg, draws, bank=tb, real_draws=real_draws)
    _hold(t, j["event"], draws, tsim.real_noise(real_draws, tb), tcfg)
    with pytest.raises(ValueError, match="real_draws"):
        tsim.simulate_event(torch.from_numpy(ev), 3, tasd(device="cpu"),
                            tcfg, draws, bank=tb)


def test_gaussian_stream_unchanged_by_a_bank(bank_dir):
    """At real_noise_prob 0 a bank changes nothing, bit for bit, and draws
    nothing from the generator; without a bank real_noise_prob is
    ignored."""
    tb = tbank.load_noise_bank(bank_dir, device="cpu")
    cfg = tsim.SimConfig(prior=tsim.PriorConfig(max_signals=2),
                         det_dropout=0.3)
    runs = []
    for kw in (dict(), dict(bank=tb), dict(cfg=dict(real_noise_prob=0.5))):
        c = tsim.SimConfig(**{**cfg.__dict__, **kw.pop("cfg", {})})
        g = torch.Generator().manual_seed(7)
        runs.append((tsim.simulate_batch(2, c, device="cpu", generator=g,
                                         **kw), g.get_state()))
    for b, state in runs[1:]:
        for x, y in zip(b, runs[0][0]):
            assert torch.equal(x, y)
        assert torch.equal(state, runs[0][1])
    assert not tsim.mixes_real_noise(cfg, tb)
