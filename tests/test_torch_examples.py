"""The port's examples (posteriflow_torch/examples/) on the CPU at small
sizes, with the toy's pieces held against the JAX example.

examples/toy_2d_npe.py imports `imr_polarizations` from
posteriflow_tpu.physics.waveforms.imr, where it does not exist (the alias
lives in the package's __init__), so it fails at import and its output
cannot be the reference. Here it is loaded with that one name supplied,
the alias it means, and its pieces are held: the masses from (Mc, q)
within 1e-6 relative; the injections on JAX's own draws (rebuilt from
its key) within 2e-3 of the whitened signal's peak (the simulator's
phase bar, tests/test_torch_sim_event.py:6-13), y within 1e-6; the model
with JAX's initial parameters loaded: the NLL within 1e-5 relative and
the inverse on the same base draws within 1e-5 (float32)."""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posteriflow_tpu.physics.waveforms as JW
import posteriflow_tpu.physics.waveforms.imr as JIMR
from posteriflow_torch.examples import (analyze_results, explore_data,
                                        toy_2d_npe)
from posteriflow_torch.train.checkpoints import flax_to_state_dict
from torch_long_bns_helpers import REPO
from torch_sim_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def jtoy():
    mp = pytest.MonkeyPatch()
    mp.setattr(JIMR, "imr_polarizations", JW.imr_polarizations,
               raising=False)
    spec = importlib.util.spec_from_file_location(
        "jax_toy_2d_npe", REPO / "examples" / "toy_2d_npe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mp.undo()
    return mod


def test_jax_example_fails_at_import():
    """The finding this file works around, still true of the JAX tree."""
    with pytest.raises(ImportError, match="imr_polarizations"):
        from posteriflow_tpu.physics.waveforms.imr import \
            imr_polarizations  # noqa: F401


def _jax_draws(key, batch):
    k_t, k_n = jax.random.split(key)
    u = np.array(jax.random.uniform(k_t, (batch, 2)))
    noise = np.array(jax.random.normal(k_n, (batch, 16384)))
    return u, noise


def test_toy_injections_match_jax(jtoy):
    mc, q = np.float32(23.5), np.float32(0.55)
    jm1, jm2 = jtoy.mc_q_to_masses(jnp.float32(mc), jnp.float32(q))
    tm1, tm2 = toy_2d_npe.mc_q_to_masses(torch.tensor(mc), torch.tensor(q))
    assert abs(float(tm1) - float(jm1)) <= 1e-6 * float(jm1)
    assert abs(float(tm2) - float(jm2)) <= 1e-6 * float(jm2)
    key = jax.random.PRNGKey(3)
    strain, y = (np.asarray(a) for a in jtoy.simulate(key, 4))
    u, noise = _jax_draws(key, 4)
    ts, ty = toy_2d_npe.toy_batch(torch.from_numpy(u),
                                  torch.from_numpy(noise))
    sig = strain - noise
    assert np.max(np.abs(ts.numpy() - strain)) <= 2e-3 * np.abs(sig).max()
    assert np.max(np.abs(ty.numpy() - y)) <= 1e-6


def _load_toy(params) -> toy_2d_npe.ToyModel:
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    renamed = {k.replace("convs_", "Conv_"): v for k, v in tree.items()}
    sd = {k.replace("Conv_", "convs_"): v
          for k, v in flax_to_state_dict(renamed).items()}
    model = toy_2d_npe.ToyModel()
    model.load_state_dict(sd, strict=True)
    return model


def test_toy_model_matches_jax(jtoy):
    key = jax.random.PRNGKey(0)
    strain, y = jtoy.simulate(key, 6)
    jm = jtoy.ToyModel()
    params = jax.jit(jm.init)(key, strain, y)
    ref = float(jax.jit(jm.apply)(params, strain, y))
    model = _load_toy(params)
    s_t, y_t = torch.from_numpy(np.array(strain)), torch.from_numpy(
        np.array(y))
    with torch.no_grad():
        got = float(model.nll(s_t, y_t))
        assert abs(got - ref) <= 1e-5 * abs(ref)
        k_s = jax.random.PRNGKey(5)
        jsamp = np.asarray(jax.jit(lambda p, k, s: jm.apply(
            p, k, s, 8, method=jtoy.ToyModel.sample))(params, k_s, strain))
        z = np.array(jax.random.normal(k_s, (6 * 8, 2)))
        tsamp = model.sample(s_t, 8, z=torch.from_numpy(z)).numpy()
    assert tsamp.shape == jsamp.shape == (6, 8, 2)
    assert np.max(np.abs(tsamp - jsamp)) <= 1e-5 * max(1.0, np.abs(
        jsamp).max())


def test_toy_cli(tmp_path):
    summary = toy_2d_npe.main(["--steps", "3", "--batch", "4", "--device",
                               "cpu", "--out", str(tmp_path)])
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert set(summary) == {"final_nll", "initial_nll", "cov50", "cov90"}
    assert len(summary["cov50"]) == len(summary["cov90"]) == 2
    assert (tmp_path / "pp.png").is_file()


def test_explore_data_cli(tmp_path):
    stats = explore_data.main(["--batch", "6", "--device", "cpu", "--out",
                               str(tmp_path)])
    assert set(stats) == {"n_sig_dist", "regimes", "whitened_std"}
    assert sum(stats["n_sig_dist"].values()) == 6
    assert 0.8 < stats["whitened_std"] < 1.5
    for f in ("strain.png", "priors.png", "spectrogram.png"):
        assert (tmp_path / f).is_file()


def test_analyze_results_cli(tmp_path):
    tour = analyze_results.main(
        ["--ckpt", str(REPO / "model_release/npe_r7_best"), "--device",
         "cpu", "--n-samples", "64", "--out", str(tmp_path)])
    res = tour["result"]
    assert res.samples.shape == (64, 15)
    assert tour["truth"].shape == (15,) and tour["importance"] is None
    assert np.isfinite(tour["abs_error"]).all()
    assert 0 < tour["reweight_ess"] <= 64
    for f in ("corner.png", "marginals.png", "recon.png",
              "result/samples.npy"):
        assert (tmp_path / f).is_file()
