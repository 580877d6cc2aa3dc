"""The slice as a whole: bench.py's path, simulate → encode → flow, on the
flagship release (model_release/FLAGSHIP) with the flagship's SimConfig
from its meta.json, B = 2 events, in float32 (encoder and conditioner
switched to float32) and as released (bfloat16).

JAX simulates the batch (jitted simulate_batch); the port builds its own
strain from the same prior draws and event draws (rebuilt from JAX's keys).
Both strains go through both packages' encoders; each context scores the
injected signal of rank 0 (the loudest) and pushes the same base draws z
through the flow.

float32 is the parity path:
  - same input (JAX's strain; the flow on JAX's context): the tolerances
    of test_torch_flagship.py, context 2e-4 of its largest entry, draws y
    1e-4, NLL 1e-3 (measured 1.9e-5, 1e-5, 6e-5);
  - end to end (the port on its own strain against JAX on its own):
    context 1e-3 of its largest entry (measured 5.7e-4). The strains differ
    by the waveforms' float32 rounding (test_torch_sim_event.py) and the
    NLL of the injection moves with them, so it is held to JAX's own move
    between the two strains plus 1e-3 (measured: the port's difference
    1.3e-3 and 2.0e-3 nats, JAX's own move 1.3e-3 and 2.0e-3); the draws'
    median |Δy| to 1e-4 (measured 3.6e-5).
bfloat16 rounds attention logits of size ~50 to steps of 0.25, so one
flipped rounding moves a pooled attention weight by up to e^0.25; on these
loud injections the released model is held to coarser bounds, which still
catch a wrong cast or a missing layer: the same-strain context to 5e-2 of
its largest entry (measured 3.2e-2; 3e-3 on the noise of
test_torch_flagship.py), the flow on JAX's context to a median |Δy| of one
bfloat16 step (2^-8) and an NLL within 0.5 nat (measured 0.41 at a steep
density: JAX's own bfloat16 NLL moves 1.2 nats between the two strains),
and end to end an NLL within JAX's own move plus 0.5 nat.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.physics.simulator import simulate_batch as jsimulate
from posteriflow_tpu.prior import sample_batch as jsample_batch
from posteriflow_tpu.train.checkpoints import CheckpointManager
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.physics.simulator import sim_config_from_dict
from posteriflow_torch.physics.simulator import simulate_batch as tsimulate
from posteriflow_torch.train.checkpoints import load_release
from torch_sim_helpers import jax_batch_inputs

ROOT = Path(__file__).resolve().parents[1]
RELEASE = ROOT / "model_release" / (ROOT / "model_release" / "FLAGSHIP") \
    .read_text().strip()
B, N, KEY = 2, 32, 21
DTYPES = ("float32", "bfloat16")
JPARAMS, JCFG, _ = CheckpointManager.load_release(RELEASE)
MODELS = {dt: JNPE(dataclasses.replace(JCFG.npe, encoder_dtype=dt,
                                       flow_dtype=dt))
          for dt in DTYPES}


@jax.jit
def _jax_all(params, key, z, port_strain):
    """JAX's batch and prior draws; then, per dtype, for the strains
    (JAX's, the port's): context, NLL of JAX's injection and draws y."""
    batch = jsimulate(key, B, JCFG.sim)
    prior = jsample_batch(jax.random.split(key)[0], B, JCFG.sim.prior)
    rank = jnp.zeros(2 * B, jnp.int32)
    strain = jnp.concatenate([batch.strain, port_strain])
    bands = jnp.concatenate([batch.asd_bands, batch.asd_bands])
    theta = jnp.concatenate([batch.params[:, 0], batch.params[:, 0]])
    zz = jnp.concatenate([z, z])
    out = {"batch": batch, "prior": prior}
    for dt, m in MODELS.items():
        ctx = m.apply(params, strain, bands, method=JNPE.encode)
        nll = m.apply(params, ctx, theta, rank,
                      method=JNPE.nll_from_context)
        full = m.apply(params, ctx, rank, method=JNPE.full_context)
        y, _ = m.apply(params, zz, full[:, None, :],
                       method=lambda mod, a, c: mod.flow.inverse(a, c))
        out[dt] = (ctx, nll, y)
    return out


def _port_strain(key, prior, sim):
    _, _, draws = jax_batch_inputs(key, B, JCFG.sim)
    params, n_sig = (torch.from_numpy(np.array(a)) for a in prior)
    return tsimulate(B, sim, device="cpu", params=params, n_sig=n_sig,
                     draws=draws)


@pytest.fixture(scope="module")
def both():
    key = jax.random.PRNGKey(KEY)
    z = np.array(jax.random.normal(jax.random.PRNGKey(KEY + 1),
                                   (B, N, 15)))
    state_dict, tcfg, meta = load_release(RELEASE)
    sim = sim_config_from_dict(meta["config"]["sim"])
    # the prior as JAX's jitted program draws it (a first call of the one
    # program, with any strain; its outputs do not depend on it)
    prior = jax.tree_util.tree_map(np.asarray, _jax_all(
        JPARAMS, key, z, np.zeros((B, 3, 16384), np.float32))["prior"])
    batch = _port_strain(key, prior, sim)
    j = jax.tree_util.tree_map(np.asarray, _jax_all(
        JPARAMS, key, z, batch.strain.numpy()))
    t = {"batch": batch}
    rank = torch.zeros(B, dtype=torch.long)
    zt = torch.from_numpy(z)
    theta = torch.from_numpy(j["batch"].params[:, 0].copy())
    for dt in DTYPES:
        m = TNPE(dataclasses.replace(tcfg, encoder_dtype=dt, flow_dtype=dt))
        m.load_state_dict(state_dict, strict=True)
        m.eval()
        with torch.no_grad():
            outs = {}
            for name, strain in (("jax_strain", j["batch"].strain),
                                 ("port_strain", batch.strain)):
                ctx = m.encode(torch.as_tensor(np.array(strain)),
                               batch.asd_bands)
                outs[name] = ctx.numpy()
            for name, ctx in (("port", outs["port_strain"]),
                              ("jax_ctx", j[dt][0][:B])):
                ctx = torch.as_tensor(np.array(ctx))
                nll = m.nll_from_context(ctx, theta, rank)
                y, _ = m.flow.inverse(zt, m.full_context(ctx, rank)[:, None])
                outs[name] = (nll.numpy(), y.numpy())
        t[dt] = outs
    return j, t, sim


def test_flagship_sim_config_and_batch(both):
    j, t, sim = both
    assert sim.prior.precessing and sim.det_dropout == 0.1
    assert sim.glitch_prob == 0.05 and sim.real_noise_prob == 0.5
    assert dataclasses.asdict(sim) == dataclasses.asdict(JCFG.sim)
    batch = t["batch"]
    assert batch.strain.shape == (B, 3, 16384)
    np.testing.assert_array_equal(batch.n_sig.numpy(), j["batch"].n_sig)
    np.testing.assert_array_equal(batch.params.numpy(), j["batch"].params)
    assert (batch.n_sig.numpy() >= 1).all()


def _scale(j, dt):
    return np.abs(j[dt][0][:B]).max()


def test_float32_same_input(both):
    """The port's encoder on JAX's strain, its flow on JAX's context."""
    j, t, _ = both
    jctx, jnll, jy = (a[:B] for a in j["float32"])
    d_ctx = np.abs(t["float32"]["jax_strain"] - jctx).max()
    assert d_ctx <= 2e-4 * _scale(j, "float32"), d_ctx
    tnll, ty = t["float32"]["jax_ctx"]
    np.testing.assert_allclose(tnll, jnll, atol=1e-3)
    np.testing.assert_allclose(ty, jy, atol=1e-4)


def test_float32_end_to_end(both):
    """The port on its own strain against JAX on its own."""
    j, t, _ = both
    jctx, jnll, jy = j["float32"]
    d_ctx = np.abs(t["float32"]["port_strain"] - jctx[:B]).max()
    assert d_ctx <= 1e-3 * _scale(j, "float32"), d_ctx
    tnll, ty = t["float32"]["port"]
    self_nll = np.abs(jnll[B:] - jnll[:B])
    assert (np.abs(tnll - jnll[:B]) <= self_nll + 1e-3).all(), (
        tnll - jnll[:B], self_nll)
    assert np.isfinite(ty).all()
    assert np.median(np.abs(ty - jy[:B])) <= 1e-4


def test_bfloat16_as_released(both):
    j, t, _ = both
    jctx, jnll, jy = j["bfloat16"]
    d_ctx = np.abs(t["bfloat16"]["jax_strain"] - jctx[:B]).max()
    assert d_ctx <= 5e-2 * _scale(j, "bfloat16"), d_ctx
    tnll, ty = t["bfloat16"]["jax_ctx"]
    assert np.isfinite(tnll).all() and np.isfinite(ty).all()
    assert np.median(np.abs(ty - jy[:B])) <= 2.0 ** -8
    np.testing.assert_allclose(tnll, jnll[:B], atol=0.5)
    enll, ey = t["bfloat16"]["port"]
    assert np.isfinite(enll).all() and np.isfinite(ey).all()
    self_nll = np.abs(jnll[B:] - jnll[:B])
    assert (np.abs(enll - jnll[:B]) <= self_nll + 0.5).all()


def test_bench_twin_runs_on_cpu():
    """posteriflow_torch/tools/bench.py at a small size: bench.py's keys,
    the device named, finite draws."""
    from posteriflow_torch.tools.bench import run
    out = run(RELEASE, device="cpu", n_events=2, n_draws=16, iters=1)
    assert {"metric", "value", "unit", "vs_baseline", "model"} <= set(out)
    assert out["metric"] == "posterior_draws_per_sec_per_chip"
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert out["value"] > 0 and len(out["n_sig"]) == 2
