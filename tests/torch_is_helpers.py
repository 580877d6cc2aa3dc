"""Shared pieces of the importance-sampling parity tests
(tests/test_torch_is_*.py): the JAX package's TINY engine of
tests/test_inference.py:27-46 with its conditioner in float32, the same
weights in a port engine on the CPU, JAX's BBH injection, and the random
draws of JAX's fused SMC sweep rebuilt from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from posteriflow_tpu import PARAM_NAMES
from posteriflow_tpu.inference.pipeline import InferenceEngine as JEngine
from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.models.npe import NPEConfig
from posteriflow_tpu.physics.simulator import SimConfig
from posteriflow_tpu.prior import PriorConfig
from posteriflow_tpu.train.checkpoints import _cfg_to_dict
from posteriflow_tpu.train.trainer import TrainConfig
from posteriflow_torch.inference.pipeline import InferenceEngine as TEngine
from posteriflow_torch.train.checkpoints import (flax_to_state_dict,
                                                 train_cfg_from_dict)

# tests/test_inference.py's TINY with the conditioner's matmuls in float32
# (in bfloat16 a density at a steep point moves by tenths of a nat between
# the packages)
TINY = TrainConfig(
    npe=NPEConfig(context_dim=32, rank_dim=8, flow_layers=2, flow_hidden=32,
                  flow_bins=4, encoder_type="conv", d_model=32,
                  enc_layers=1, enc_heads=4, flow_dtype="float32"),
    sim=SimConfig(prior=PriorConfig(max_signals=2)),
    batch_size=8, warmup_steps=5, total_steps=50)

BBH = {"mass_1": 36.0, "mass_2": 29.0, "luminosity_distance": 400.0,
       "ra": 1.0, "dec": -0.5, "theta_jn": 0.5, "psi": 0.3, "phase": 1.0,
       "geocent_time": 0.2, "a1": 0.1, "a2": 0.05}
TRUTH = np.array([[BBH[k] for k in PARAM_NAMES]], np.float32)


def engines():
    """(JAX engine, port engine on the CPU) with the same weights: TINY's
    parameters from PRNGKey(0) as init_state draws them (its model.init,
    jitted: flax's eager init takes ~25 s on the CPU)."""
    model = JNPE(TINY.npe)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 16384)),
        jnp.ones((2, 11)) * 0.5, jnp.zeros((2,), jnp.int32), None)
    jeng = JEngine(params, TINY)
    cfg = train_cfg_from_dict(_cfg_to_dict(TINY)).npe
    teng = TEngine(flax_to_state_dict(jax.device_get(params)), cfg,
                   device="cpu")
    return jeng, teng


def jax_sweep_draws(seed: int, n_mcmc: int, n: int, d_x: int):
    """The normals [n_mcmc, n, d_x] and uniforms [n_mcmc, n] JAX's
    _make_fused_move draws from PRNGKey(seed): split(key, n_mcmc), then per
    step k1, k2 = split(k), normal(k1, (n, d_x)), uniform(k2, (n,))."""
    normals, uniforms = [], []
    for k in jax.random.split(jax.random.PRNGKey(seed), n_mcmc):
        k1, k2 = jax.random.split(k)
        normals.append(np.asarray(jax.random.normal(k1, (n, d_x))))
        uniforms.append(np.asarray(jax.random.uniform(k2, (n,))))
    return (torch.from_numpy(np.stack(normals)),
            torch.from_numpy(np.stack(uniforms)))


def use_jax_draws(monkeypatch):
    """Make the port's sweeps draw what JAX's draw for the same seed."""
    from posteriflow_torch.inference import importance

    def draws(seed, n_mcmc, n, d_x, device):
        nrm, uni = jax_sweep_draws(seed, n_mcmc, n, d_x)
        return nrm.to(device), uni.to(device)
    monkeypatch.setattr(importance, "mcmc_draws", draws)
