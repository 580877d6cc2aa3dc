"""Serving a request on an injection: `infer(engine, inject=...)` and
`prepare_simulated` against the JAX package's, on a small 15-D float32
release written the way the JAX package writes one, with the noise JAX
derives from the seed (its event draws, rebuilt from PRNGKey(seed)) and
JAX's base draws from PRNGKey(seed + 7).

Tolerances: the injection's strain as in test_torch_sim_event.py (1e-4
plus 2e-3 of the whitened signal's peak); the truth bit for bit (the gate
copies it); samples rtol 1e-4 and atol 1e-4, log q atol 1e-3, as
test_torch_pipeline.py holds the engine (the contexts here come from
strains that differ by the waveforms' float32 rounding; measured
differences are below 2e-5)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_bytes

from posteriflow_tpu.inference import pipeline as jpipe
from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.models.npe import NPEConfig as JCfg
from posteriflow_tpu.physics.simulator import SimConfig
from posteriflow_tpu.prior import PriorConfig
from posteriflow_tpu.train.checkpoints import _cfg_to_dict
from posteriflow_tpu.train.trainer import TrainConfig
from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import pipeline as tpipe
from posteriflow_torch.inference.preprocessing import prepare_simulated
from torch_sim_helpers import DRAWS, jax_event_draws

SEED, N = 3, 64
SMALL = dict(param_names=PARAM_NAMES_PRECESSING, context_dim=24, rank_dim=8,
             flow_layers=2, flow_hidden=32, flow_bins=4, d_model=32,
             enc_layers=1, enc_heads=4, psd_cond=True,
             encoder_dtype="float32", flow_dtype="float32")
NAMES = PARAM_NAMES_PRECESSING
INJECT = [dict(zip(NAMES, DRAWS["bbh"])),
          # aligned keys only: the precession block defaults to 0
          dict(zip(NAMES[:11], DRAWS["nsbh"][:11]))]


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    cfg = TrainConfig(npe=JCfg(**SMALL),
                      sim=SimConfig(prior=PriorConfig(precessing=True)))
    params = jax.device_get(JNPE(cfg.npe).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16384)),
        jnp.full((1, 15), 1.5), jnp.zeros(1, jnp.int32),
        jnp.zeros((1, 3, 16))))
    rng = np.random.default_rng(5)
    params["params"]["flow"] = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        params["params"]["flow"])
    d = tmp_path_factory.mktemp("release15")
    (d / "params.msgpack").write_bytes(to_bytes(params))
    (d / "meta.json").write_text(json.dumps({"config": _cfg_to_dict(cfg)}))
    return d


@pytest.fixture(scope="module")
def both(release):
    jeng = jpipe.InferenceEngine.from_checkpoint(release)
    teng = tpipe.InferenceEngine.from_checkpoint(release, device="cpu")
    draws = jax_event_draws(jax.random.PRNGKey(SEED))
    jprep = jpipe._prepare(jeng, inject=INJECT, seed=SEED)
    tprep = tpipe._prepare(teng, inject=INJECT, seed=SEED, draws=draws)
    jres = jpipe.infer(jeng, inject=INJECT, seed=SEED, n_samples=N)
    z = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(SEED + 7), (1, N, 15))))
    tres = tpipe.infer(teng, inject=INJECT, seed=SEED, n_samples=N,
                       draws=draws, z=z)
    return jprep, tprep, jres, tres, draws


def test_prepare_simulated_matches_jax(both):
    jprep, tprep, _, _, draws = both
    np.testing.assert_array_equal(tprep.truth, jprep.truth)
    assert tprep.truth.shape == (2, 15)
    peak = np.abs(jprep.strain - draws.noise.numpy()).max()
    err = np.abs(tprep.strain - jprep.strain).max()
    assert err <= 1e-4 + 2e-3 * peak, (err, peak)
    np.testing.assert_array_equal(tprep.asd_bands, jprep.asd_bands)
    np.testing.assert_array_equal(tprep.asds, jprep.asds)
    assert tprep.detectors_present == jprep.detectors_present
    assert set(tprep.quality) == set(jprep.quality)
    assert "prepare" in tprep.timings


def test_infer_on_injection_matches_jax(both):
    _, _, jres, tres, _ = both
    assert tres.samples.shape == jres.samples.shape == (N, 15)
    np.testing.assert_allclose(tres.samples, jres.samples, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tres.log_prob, jres.log_prob, atol=1e-3)
    np.testing.assert_array_equal(tres.railed, jres.railed)
    assert tres.verdict == jres.verdict
    rt = tres.diagnostics["runtime"]
    assert {"prepare", "encode", "sampling"} <= set(rt)


def test_injection_forms_and_errors():
    """An array injects what the dicts do; a missing base key raises; the
    port's own draws are seeded."""
    arr = np.array([[d.get(k, 0.0) for k in NAMES] for d in INJECT],
                   np.float32)
    draws = jax_event_draws(jax.random.PRNGKey(1))
    a = prepare_simulated(arr, device="cpu", draws=draws)
    b = prepare_simulated(INJECT, param_names=NAMES, device="cpu",
                          draws=draws)
    np.testing.assert_array_equal(a.strain, b.strain)
    bad = dict(INJECT[0])
    del bad["mass_2"]
    with pytest.raises(KeyError):
        prepare_simulated([bad], param_names=NAMES, device="cpu")
    c = prepare_simulated(INJECT[:1], param_names=NAMES, seed=4,
                          device="cpu")
    d = prepare_simulated(INJECT[:1], param_names=NAMES, seed=4,
                          device="cpu")
    np.testing.assert_array_equal(c.strain, d.strain)
    assert np.isfinite(c.strain).all() and c.strain.shape == (3, 16384)


def test_infer_inject_on_the_ports_own_rng(release):
    eng = tpipe.InferenceEngine.from_checkpoint(release, device="cpu")
    r1 = tpipe.infer(eng, inject=INJECT, seed=9, n_samples=16)
    r2 = tpipe.infer(eng, inject=INJECT, seed=9, n_samples=16)
    np.testing.assert_array_equal(r1.samples, r2.samples)
    assert np.isfinite(r1.samples).all() and np.isfinite(r1.log_prob).all()
