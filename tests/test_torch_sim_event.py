"""The port's SNR gate and event assembly against the JAX package's, given
JAX's own prior draws and event draws (noise, fill, dropout, glitches,
rebuilt from its keys by tests/torch_sim_helpers.py).

Tolerances: the gate is bit-equal given JAX's SNRs (it is comparisons,
counts and a one-hot copy). Strain: within an absolute 1e-4 plus 2e-3 of
the peak of the event's whitened signal. The noise is shared exactly; the
signal carries Ψ's float32 rounding (~1e-3 rad at Ψ ~ 1e4 rad), so a loud
signal cannot agree to 1e-4: JAX's own jitted and eager runs of one BBH
waveform (whitened peak 5.27) differ by 6.2e-3 in time, 1.2e-3 of the
peak, and the port differs from the jitted run by as much. Per-signal SNRs within 1e-5 relative; the network SNR of
overlapping signals within 1e-4 relative, since its cross terms carry each
signal's float32 phase rounding (Ψ ~ 1e4 rad, one step ~ 1e-3 rad;
measured 1.8e-5 on three overlapping signals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics import simulator as jsim
from posteriflow_tpu.physics.psd import default_network_asd as jasd
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.prior import sample_batch as jsample_batch
from posteriflow_torch.physics import simulator as tsim
from posteriflow_torch.physics.psd import default_network_asd as tasd
from torch_sim_helpers import (draws_array, jax_batch_inputs,
                               jax_event_draws, port_sim_config)

STRAIN_ATOL, SIG_RTOL, SNR_RTOL, NET_SNR_RTOL = 1e-4, 2e-3, 1e-5, 1e-4
CFGS = {
    "aligned": jsim.SimConfig(prior=JPrior(max_signals=3), det_dropout=0.5,
                              glitch_prob=0.5),
    "precessing": jsim.SimConfig(prior=JPrior(max_signals=3, precessing=True),
                                 det_dropout=0.5, glitch_prob=0.5),
}
EVENT_CFG = jsim.SimConfig(prior=JPrior(max_signals=4, precessing=True),
                           min_snr=8.0, glitch_prob=1.0)
KEYS = {"aligned": 11, "precessing": 12, "event": 13}
B = 4


def _gate_inputs():
    """[6, 4] slots with exact loudness ties (repeated slots), SNRs on both
    sides of the threshold and exactly on it, every n_sig."""
    rng = np.random.default_rng(0)
    p = draws_array(15)[rng.integers(0, 4, (6, 4))]
    p[..., 2] *= rng.uniform(0.5, 2.0, (6, 4)).astype(np.float32)
    p[1, 3] = p[1, 0]                       # tie, lower index wins
    p[2, 1] = p[2, 2] = p[2, 3]             # three-way tie
    snr = rng.uniform(4.0, 12.0, (6, 4)).astype(np.float32)
    snr[3, :2] = 8.0                        # on the threshold: kept
    n_sig = np.array([0, 4, 4, 2, 3, 1], np.int32)
    return p, snr, n_sig


@jax.jit
def _jax_all(gate_p, gate_snr, gate_n, ev_params, ev_n, asd):
    out = {"gate": jax.vmap(lambda q, s, n: jsim._gate_from_snr(
        q, s, n, 8.0))(gate_p, gate_snr, gate_n)}
    out["event"] = jsim.simulate_event(jax.random.PRNGKey(KEYS["event"]),
                                       ev_params, ev_n, asd, EVENT_CFG)
    for name, cfg in CFGS.items():
        key = jax.random.PRNGKey(KEYS[name])
        out[name] = jsim.simulate_batch(key, B, cfg)
        # the prior draws as this program computes them (eager and jitted
        # evaluation of the prior round differently)
        out[name + "_prior"] = jsample_batch(jax.random.split(key)[0], B,
                                             cfg.prior)
    return out


@pytest.fixture(scope="module")
def jax_out():
    p, snr, n = _gate_inputs()
    ev = draws_array(15)[[0, 2, 1, 3]]
    ev[1, 2] = 60.0                         # the NSBH loudest
    out = _jax_all(p, snr, n, ev, jnp.int32(3), jasd())
    return jax.tree_util.tree_map(np.asarray, out), (p, snr, n), ev


def test_gate_is_bit_equal(jax_out):
    j, (p, snr, n), _ = jax_out
    t = tsim._gate_from_snr(torch.from_numpy(p), torch.from_numpy(snr),
                            torch.from_numpy(n), 8.0)
    for a, b in zip(t, j["gate"]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert t[3].dtype == torch.int32


def _strain_tol(j, draws, cfg):
    """Per event: 1e-4 plus 2e-3 of the peak of JAX's whitened signal sum
    (its strain less the shared noise and glitches, on kept detectors)."""
    noise = draws.noise.numpy() + (tsim._glitch_burst(draws, cfg.glitch_prob)
                                   .numpy() if cfg.glitch_prob > 0 else 0.0)
    sig = np.where(j.det_mask[..., None] > 0, j.strain - noise, 0.0)
    peak = np.abs(sig).max(axis=(-2, -1))
    return STRAIN_ATOL + SIG_RTOL * peak


def _hold_event(t, j, draws, cfg):
    np.testing.assert_array_equal(t.n_sig.numpy(), j.n_sig)
    np.testing.assert_array_equal(t.det_mask.numpy(), j.det_mask)
    np.testing.assert_array_equal(t.params.numpy(), j.params)
    np.testing.assert_array_equal(t.asd_bands.numpy(), j.asd_bands)
    np.testing.assert_allclose(t.sig_snr.numpy(), j.sig_snr, rtol=SNR_RTOL)
    np.testing.assert_allclose(t.net_snr.numpy(), j.net_snr,
                               rtol=NET_SNR_RTOL)
    assert t.strain.dtype == torch.float32
    err = np.abs(t.strain.numpy() - j.strain).max(axis=(-2, -1))
    assert (err <= _strain_tol(j, draws, cfg)).all(), err


def test_simulate_event(jax_out):
    """simulate_event without `pre`: the gate SNR is the full waveform's
    norm; the glitch fires (glitch_prob 1)."""
    j, _, ev = jax_out
    draws = jax_event_draws(jax.random.PRNGKey(KEYS["event"]))
    cfg = port_sim_config(EVENT_CFG)
    t = tsim.simulate_event(torch.from_numpy(ev), 3, tasd(device="cpu"), cfg,
                            draws)
    _hold_event(t, j["event"], draws, cfg)
    assert int(t.n_sig) == 3


@pytest.mark.parametrize("name", list(CFGS))
def test_simulate_batch(jax_out, name):
    """The two-pass batch (decimated amplitude-only gate SNR, then the
    masked slot sum) with dropout and glitches, given JAX's draws."""
    j = jax_out[0][name]
    params, n_sig = (a.copy() for a in jax_out[0][name + "_prior"])
    cfg = CFGS[name]
    _, _, draws = jax_batch_inputs(jax.random.PRNGKey(KEYS[name]), B, cfg)
    tcfg = port_sim_config(cfg)
    t = tsim.simulate_batch(B, tcfg, device="cpu",
                            params=torch.from_numpy(params),
                            n_sig=torch.from_numpy(n_sig), draws=draws)
    _hold_event(t, j, draws, tcfg)
    assert t.strain.shape == (B, 3, 16384)


def test_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = tsim.draw_events((5,), g, "cpu")
    assert d.noise.shape == d.fill.shape == (5, 3, 16384)
    assert d.keep_idx.min() >= 0 and d.keep_idx.max() < 6
    assert d.glitch_n.min() >= 1 and d.glitch_n.max() <= 3
    assert (d.glitch_widths >= 20).all() and (d.glitch_widths <= 200).all()
    assert (d.glitch_amps >= 2).all() and (d.glitch_amps <= 8).all()
    one = tsim.draw_events((), g, "cpu")
    assert one.noise.shape == (3, 16384) and one.drop_u.shape == ()
