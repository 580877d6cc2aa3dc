"""Shared pieces of the overlap-path parity tests
(tests/test_torch_priority_*.py, tests/test_torch_overlap_*.py): released
PriorityNets in both packages, a scenario batch with dead slots, and the
JAX draws of the priority batch rebuilt from its key."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from posteriflow_tpu.models.priority_net import PriorityNet as JNet
from posteriflow_torch.train.train_priority import load_priority_net
from torch_sim_helpers import jax_batch_inputs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch during each test of a module that
    imports this fixture. The suite runs in several worker processes on
    one machine; the slices' small ops with a thread pool each then wait
    on one another (a 300-step fit took 60 times its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
RELEASES = ("priority_v7", "priority_v5")


def jax_release(name: str):
    """(flax PriorityNet, params) of a released net, its tree read with
    msgpack_restore (no eager init) and its net.json flags."""
    d = ROOT / "model_release" / name
    m = json.loads((d / "net.json").read_text())
    net = JNet(d_model=m["d_model"], use_energy=m["use_energy"],
               use_snr_est=m["use_snr_est"], use_dt=m.get("use_dt", False),
               residual_snr=m.get("residual_snr", False))
    params = msgpack_restore((d / "priority_params.msgpack").read_bytes())
    return net, params


def port_release(name: str):
    return load_priority_net(ROOT / "model_release" / name
                             / "priority_params.msgpack", device="cpu")


def scenario(seed: int, b: int = 4, n: int = 4):
    """(segments [b, n, 3, 2048], params [b, n, 11], mask [b, n], snr_est
    [b, n]) as numpy: N(0, 1) segments with a chirp-like bump, prior-like
    parameters, mergers within ±1 s (two of them 0.1 s apart), dead slots
    (zero parameters, zero SNR) in three of the events."""
    rng = np.random.default_rng(seed)
    segs = rng.standard_normal((b, n, 3, 2048)).astype(np.float32)
    segs[..., 900:1100] *= 1.0 + 2.0 * rng.uniform(0, 1, (b, n, 3, 1))
    params = np.stack([
        rng.uniform(10, 80, (b, n)), rng.uniform(5, 40, (b, n)),
        rng.uniform(200, 1500, (b, n)), rng.uniform(0, 6.28, (b, n)),
        rng.uniform(-1.4, 1.4, (b, n)), rng.uniform(0, 3.1, (b, n)),
        rng.uniform(0, 3.1, (b, n)), rng.uniform(0, 6.28, (b, n)),
        rng.uniform(-1, 1, (b, n)), rng.uniform(0, 0.9, (b, n)),
        rng.uniform(0, 0.9, (b, n))], axis=-1).astype(np.float32)
    params[0, 1, 8] = params[0, 0, 8] + 0.1
    mask = np.ones((b, n), np.float32)
    mask[1, 3:] = 0
    mask[2, 2:] = 0
    mask[3, 1:] = 0
    params[mask == 0] = 0.0
    snr = (rng.uniform(6, 40, (b, n)) * mask).astype(np.float32)
    return segs, params, mask, snr


def jax_priority_draws(key, jcfg):
    """What JAX's make_priority_batch(key, jcfg) draws: the simulation
    inputs of its batch_size · mine_pool events (params, n_sig, SimDraws)
    and the jitter normals [batch_size, S, 11]."""
    k_sim, k_jit = jax.random.split(key)
    n_gen = jcfg.batch_size * max(jcfg.mine_pool, 1)
    params, n_sig, draws = jax_batch_inputs(k_sim, n_gen, jcfg.sim)
    s = jcfg.sim.prior.max_signals
    jitter = np.asarray(jax.random.normal(k_jit, (jcfg.batch_size, s, 11)))
    return ((torch.tensor(params), torch.tensor(n_sig.astype(np.int64)),
             draws), torch.tensor(jitter))


def jnp_tree(a):
    return jax.tree.map(jnp.asarray, a)
