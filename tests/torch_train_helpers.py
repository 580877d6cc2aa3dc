"""Shared inputs of the training tests of the port (tests/test_torch_train_*):
twin TrainConfigs of the JAX package and the port, event batches built
from numpy, and JAX parameters carried into a port model.

The configs are the small ones of tests/test_train.py:20-25 (conv encoder,
11-D) and __graft_entry__.py:21-33 (coherent encoder, 15-D precessing),
with the flow and the encoder in float32 unless a test asks otherwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from posteriflow_tpu import PARAM_NAMES_PRECESSING
from posteriflow_tpu.models.npe import NPEConfig as JNPEConfig
from posteriflow_tpu.physics.simulator import EventBatch as JBatch
from posteriflow_tpu.physics.simulator import SimConfig as JSimConfig
from posteriflow_tpu.prior import PriorConfig as JPrior
from posteriflow_tpu.train.trainer import TrainConfig as JTrainConfig
from posteriflow_tpu.train.trainer import init_state as jinit_state
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.physics.simulator import EventBatch as TBatch
from posteriflow_torch.prior import sample_batch as tsample_batch
from posteriflow_torch.train.checkpoints import (_cfg_to_dict,
                                                 flax_to_state_dict,
                                                 train_cfg_from_dict)

CONFIGS = {
    "conv": JTrainConfig(
        npe=JNPEConfig(context_dim=32, rank_dim=8, flow_layers=2,
                       flow_hidden=32, flow_bins=4, encoder_type="conv",
                       d_model=32, enc_layers=1, enc_heads=4,
                       flow_dtype="float32"),
        sim=JSimConfig(prior=JPrior(max_signals=2), det_dropout=0.1),
        batch_size=8, warmup_steps=2, total_steps=10, lr=1e-3),
    "coherent": JTrainConfig(
        npe=JNPEConfig(param_names=PARAM_NAMES_PRECESSING, context_dim=32,
                       rank_dim=8, flow_layers=2, flow_hidden=32,
                       flow_bins=4, encoder_type="coherent", d_model=32,
                       enc_layers=1, enc_heads=4, flow_dtype="float32"),
        sim=JSimConfig(prior=JPrior(max_signals=2, precessing=True),
                       det_dropout=0.1, glitch_prob=0.05),
        batch_size=8, warmup_steps=2, total_steps=10),
}


def port_config(jcfg):
    """The port's TrainConfig with the same fields as a JAX TrainConfig."""
    return train_cfg_from_dict(_cfg_to_dict(jcfg))


def with_dtype(jcfg, dtype: str):
    """jcfg with its flow and encoder matmuls in `dtype`."""
    return dataclasses.replace(jcfg, npe=dataclasses.replace(
        jcfg.npe, flow_dtype=dtype, encoder_dtype=dtype))


def batches(jcfg, n_batches: int, batch: int, seed: int):
    """[(JAX EventBatch, port EventBatch)] of the same numpy arrays: prior
    draws of the port's prior, N(0, 1) whitened strain, ASD bands N(0,
    0.1²), SNRs U(8, 30), all detectors present."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    tcfg = port_config(jcfg)
    out = []
    for _ in range(n_batches):
        params, n_sig = tsample_batch(batch, tcfg.sim.prior, gen, "cpu")
        s = params.shape[1]
        arrays = dict(
            strain=rng.standard_normal((batch, 3, 16384)).astype(np.float32),
            params=params.numpy().astype(np.float32),
            n_sig=n_sig.numpy().astype(np.int32),
            net_snr=rng.uniform(8, 30, batch).astype(np.float32),
            sig_snr=rng.uniform(8, 30, (batch, s)).astype(np.float32),
            asd_bands=(rng.standard_normal((batch, 3, tcfg.sim.psd_bands))
                       * 0.1).astype(np.float32),
            det_mask=np.ones((batch, 3), np.float32))
        out.append((JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                    TBatch(**{k: torch.from_numpy(v)
                              for k, v in arrays.items()})))
    return out


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(lambda key: jinit_state(key, jcfg).params)


def jax_params(jcfg, seed: int = 0):
    """JAX's init_state parameters (jitted: flax's eager init of the
    coherent encoder takes half a minute on the CPU)."""
    return _jit_init(jcfg)(jax.random.PRNGKey(seed))


def port_model(jcfg, params) -> TNPE:
    """A port model of jcfg's NPEConfig holding the JAX parameters."""
    model = TNPE(port_config(jcfg).npe)
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                          strict=True)
    return model


def to_state_dict(tree) -> dict:
    """A flax tree (parameters or gradients) in the port's layout."""
    return flax_to_state_dict(jax.device_get(tree))
