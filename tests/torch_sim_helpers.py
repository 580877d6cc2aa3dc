"""Shared pieces of the simulator parity tests (tests/test_torch_sim_*.py,
tests/test_torch_data_*.py): JAX's own event draws, rebuilt from its keys
and handed to the port as SimDraws (and its real-noise draws, from k_use
and k_real, as RealDraws), and the waveform match."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from posteriflow_tpu.physics.constants import N_DETECTORS, N_SAMPLES
from posteriflow_tpu.prior import sample_batch as jsample_batch
from posteriflow_torch.data.noise_bank import RealNoiseDraws
from posteriflow_torch.physics.simulator import RealDraws
from posteriflow_torch.physics.simulator import SimConfig as TSimConfig
from posteriflow_torch.physics.simulator import SimDraws
from posteriflow_torch.prior import PriorConfig as TPriorConfig

# one signal per event type, and an extreme-mass-ratio precessing draw:
# m1, m2, d, ra, dec, theta_jn, psi, phase, t_off, a1, a2,
# tilt_1, tilt_2, phi_12, phi_jl
DRAWS = {
    "bbh": [36.0, 29.0, 400.0, 1.0, -0.3, 0.4, 0.7, 1.2, 0.1, 0.3, 0.2,
            0.6, 2.0, 1.0, 4.0],
    "bns": [1.6, 1.3, 40.0, 2.0, 0.5, 2.1, 0.2, 4.0, -0.4, 0.03, 0.02,
            1.0, 0.5, 2.0, 1.0],
    "nsbh": [8.0, 1.4, 100.0, 4.5, -0.9, 1.2, 2.5, 0.5, 1.1, 0.7, 0.04,
             1.3, 0.3, 5.0, 2.5],
    "extreme_q": [90.0, 4.2, 300.0, 0.2, 1.1, 0.9, 1.7, 3.3, -1.2, 0.95,
                  0.9, 1.5, 1.6, 0.1, 6.0],
}


@pytest.fixture
def one_torch_thread():
    """One intra-op torch thread for a test (a module uses it as an autouse
    fixture): the suite runs in several worker processes on one machine,
    and a thread pool a worker makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draws_array(n_params: int) -> np.ndarray:
    return np.array([v[:n_params] for v in DRAWS.values()], np.float32)


def port_sim_config(jcfg) -> TSimConfig:
    d = dataclasses.asdict(jcfg)
    prior = TPriorConfig(**d.pop("prior"))
    return TSimConfig(prior=prior, **d)


def jax_event_draws(key) -> SimDraws:
    """The draws JAX's simulate_event takes from `key`, as the port's
    SimDraws (CPU tensors)."""
    (k_noise, k_drop, k_cfg, k_fill, _k_real, _k_use,
     k_glitch) = jax.random.split(key, 7)
    k_u, k_det, k_n, k_c, k_w, k_a = jax.random.split(k_glitch, 6)
    r = jax.random
    vals = dict(
        noise=r.normal(k_noise, (N_DETECTORS, N_SAMPLES)),
        fill=r.normal(k_fill, (N_DETECTORS, N_SAMPLES)),
        drop_u=r.uniform(k_drop),
        keep_idx=r.randint(k_cfg, (), 0, 6),
        glitch_u=r.uniform(k_u),
        glitch_det=r.randint(k_det, (), 0, N_DETECTORS),
        glitch_n=r.randint(k_n, (), 1, 4),
        glitch_centers=r.randint(k_c, (3,), 0, N_SAMPLES),
        glitch_widths=r.uniform(k_w, (3,), minval=20.0, maxval=200.0),
        glitch_amps=r.uniform(k_a, (3,), minval=2.0, maxval=8.0))
    out = {}
    for k, v in vals.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                  else a.astype(np.float32))
    return SimDraws(**out)


def jax_real_draws(key, n_segments: int, segment_len: int) -> RealDraws:
    """The real-noise draws JAX's simulate_event takes from `key` with a
    bank of n_segments segments of segment_len samples: the coin from
    k_use, and sample_real_noise's (segment, offset, flip) per detector
    from the first split of k_real."""
    (_, _, _, _, k_real, k_use, _) = jax.random.split(key, 7)
    k_r1, _ = jax.random.split(k_real)
    use_u = torch.from_numpy(np.array(jax.random.uniform(k_use),
                                        np.float32))
    return RealDraws(use_u, jax_crop_draws(k_r1, n_segments, segment_len))


def jax_crop_draws(key, n_segments: int, segment_len: int) -> RealNoiseDraws:
    """The (segment, offset, flip) per detector that JAX's
    sample_real_noise(key, bank) draws."""
    k_seg, k_off, k_flip = jax.random.split(key, 3)
    r = jax.random
    return RealNoiseDraws(
        seg_idx=torch.from_numpy(np.asarray(
            r.randint(k_seg, (N_DETECTORS,), 0, n_segments)).astype(np.int64)),
        off=torch.from_numpy(np.asarray(
            r.randint(k_off, (N_DETECTORS,), 0,
                      segment_len - N_SAMPLES)).astype(np.int64)),
        flip=torch.from_numpy(np.asarray(
            r.bernoulli(k_flip, 0.5, (N_DETECTORS,)))))


def jax_batch_real_draws(key, batch: int, n_segments: int,
                         segment_len: int) -> RealDraws:
    """jax_real_draws of every event of JAX's simulate_batch(key, batch)."""
    keys = jax.random.split(jax.random.split(key)[1], batch)
    per = [jax_real_draws(k, n_segments, segment_len) for k in keys]
    return RealDraws(torch.stack([p.use_u for p in per]),
                     RealNoiseDraws(*[torch.stack(f) for f in
                                      zip(*[p.crop for p in per])]))


def stack_draws(draws) -> SimDraws:
    return SimDraws(*[torch.stack(f) for f in zip(*draws)])


def jax_batch_inputs(key, batch: int, jcfg):
    """What JAX's simulate_batch(key, batch, jcfg) draws: (params
    [B, S, P], n_sig [B]) as numpy, evaluated eagerly (a jitted program
    may round the prior's arithmetic differently), and the stacked event
    draws."""
    k_prior, k_sim = jax.random.split(key)
    params, n_sig = jsample_batch(k_prior, batch, jcfg.prior)
    keys = jax.random.split(k_sim, batch)
    draws = stack_draws([jax_event_draws(k) for k in keys])
    return np.asarray(params), np.asarray(n_sig), draws


def match(a: np.ndarray, b: np.ndarray) -> float:
    """|<a, b>| / (|a| |b|) over the last axis, in complex128."""
    a = a.astype(np.complex128)
    b = b.astype(np.complex128)
    return float(np.abs(np.vdot(a, b))
                 / np.sqrt(np.vdot(a, a).real * np.vdot(b, b).real))
