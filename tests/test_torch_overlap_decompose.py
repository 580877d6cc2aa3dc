"""The subtract-and-reinfer layer of the port against the JAX package on
the CPU: AdaptiveSubtractor, AHSDPipeline.decompose and the batched
decompose on the JAX tests' TINY engine (the same weights in both
packages, JAX's base draws rebuilt from its keys and handed in), the
baselines and the output calibrator.

Tolerances: the subtractor's residual (the strain is a noiseless
injection, so the whitened signal itself) within 1e-4 plus 2e-3 of the
signal's peak, the waveform tolerance of tests/test_torch_sim_*.py: the
two packages' float32 waveform phases differ at that level, so each
package's template removes its own injection better than the other's
(1e-4 of the peak alone is not met: 1.2e-3 here); its α, fit and template
SNR and quality within 1e-4 relative. In the decompositions α, fit SNR,
quality within 1e-3 of the array's largest |value| (the flow's draws
agree to ~1e-4, and an untrained model's fit statistics are small
numbers that cancel) and the stage medians within 1e-3 of each
parameter's own largest |value|; accepted flags equal, at
thresholds chosen away from every quality of the case. The baselines'
fit SNRs within 1e-3 relative and residual powers within 1e-3 of the
data's power."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_overlap_helpers import one_torch_thread  # noqa: F401
from torch_is_helpers import BBH, TINY, TRUTH, engines

from posteriflow_tpu.core.calibrator import OutputCalibrator as JCal
from posteriflow_tpu.core.pipeline import AHSDPipeline as JPipe
from posteriflow_tpu.core.pod import make_batched_decompose as jbatched
from posteriflow_tpu.core.subtractor import AdaptiveSubtractor as JSub
from posteriflow_tpu.evaluation import benchmarks as jbench
from posteriflow_tpu.inference.preprocessing import prepare_simulated as jprep
from posteriflow_torch import PARAM_NAMES
from posteriflow_torch.core.calibrator import OutputCalibrator
from posteriflow_torch.core.pipeline import AHSDPipeline
from posteriflow_torch.core.pod import make_batched_decompose
from posteriflow_torch.core.subtractor import AdaptiveSubtractor
from posteriflow_torch.evaluation import benchmarks as tbench
from posteriflow_torch.parallel.mesh import init_distributed, make_mesh
from posteriflow_torch.inference.preprocessing import (PreparedData,
                                                       prepare_simulated)
from posteriflow_torch.physics.simulator import simulate_batch
from posteriflow_torch.train.checkpoints import (_cfg_to_dict,
                                                 train_cfg_from_dict)

TWO = [BBH, {**BBH, "mass_1": 15.0, "mass_2": 12.0,
             "luminosity_distance": 600.0, "geocent_time": -0.7}]


@pytest.fixture(scope="module")
def tiny():
    return engines()


def _close(got, ref, tol=1e-3):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) <= tol * float(np.abs(ref).max())


def _close_columns(got, ref, tol=1e-3):
    """Each parameter (the last axis) within tol of its own largest
    |value|: the distance's hundreds of Mpc set no other column's bar."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    axes = tuple(range(ref.ndim - 1))
    err = np.abs(got - ref).max(axis=axes)
    return bool((err <= tol * np.abs(ref).max(axis=axes)).all()), err


def test_subtractor_removes_injected_signal_as_jax():
    prep = prepare_simulated([BBH], seed=7, add_noise=False, device="cpu")
    draws = np.repeat(TRUTH, 64, axis=0)             # a delta posterior
    out = AdaptiveSubtractor(device="cpu").subtract(prep.strain, draws)
    sig_power = float((prep.strain ** 2).sum())
    assert out["accepted"] and out["alpha"] == pytest.approx(1.0, abs=0.05)
    assert float((out["residual"] ** 2).sum()) < 0.02 * sig_power
    ref = JSub().subtract(prep.strain, draws)
    peak = float(np.abs(prep.strain).max())
    assert np.abs(out["residual"] - np.asarray(ref["residual"])).max() \
        <= 1e-4 + 2e-3 * peak
    for k in ("alpha", "fit_snr", "template_snr", "quality"):
        assert out[k] == pytest.approx(ref[k], rel=1e-4), k
    assert out["residual_fd"].shape == (3, 8193)


@pytest.mark.parametrize("threshold", [0.3, -0.5])
def test_decompose_matches_jax(tiny, threshold):
    """Qualities of this case are 0.006-0.06: at 0.3 the gate stops at
    stage 0, at -0.5 all three stages extract."""
    jeng, teng = tiny
    prep = jprep(TWO, seed=8)
    tprep = PreparedData(**{f.name: getattr(prep, f.name)
                            for f in dataclasses.fields(PreparedData)})
    n = 256
    ref = JPipe(jeng, max_signals=3, n_samples=n,
                quality_threshold=threshold).decompose(prep, seed=0)
    z = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(s + 7), (1, n, 11)))) for s in range(3)]
    got = AHSDPipeline(teng, max_signals=3, n_samples=n,
                       quality_threshold=threshold).decompose(tprep, z=z)
    assert got["n_extracted"] == ref["n_extracted"]
    assert got["n_extracted"] == (0 if threshold > 0 else 3)
    assert len(got["stages"]) == len(ref["stages"])
    for a, b in zip(got["stages"], ref["stages"]):
        assert a["accepted"] == b["accepted"] and a["stage"] == b["stage"]
        for k in ("alpha", "quality", "fit_snr", "template_snr",
                  "residual_power_ratio"):
            assert _close(a[k], b[k]), (k, a[k], b[k])
    for a, b in zip(got["results"], ref["results"]):
        ok, err = _close_columns(a.median(), b.median())
        assert ok, err
    assert got["final_residual_power_ratio"] == pytest.approx(
        ref["final_residual_power_ratio"], rel=1e-3)


def test_batched_decompose_matches_jax(tiny, tmp_path):
    """Threshold 0.01: the gate accepts two events at stage 0 (quality
    0.018) and rejects the others (-0.14 to 0.00), whose stage 1 is then
    masked inactive. The same call with mesh= on a one-rank group returns
    the same arrays bit for bit (tests/test_torch_dist_train.py holds two
    ranks against one)."""
    jeng, teng = tiny
    cfg = train_cfg_from_dict(_cfg_to_dict(TINY))
    ev = simulate_batch(4, cfg.sim, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    strain, bands = ev.strain.numpy(), ev.asd_bands.numpy()
    key = jax.random.PRNGKey(2)
    kw = dict(n_samples=64, max_stages=2, quality_threshold=0.01,
              n_template_draws=16)
    ref = {k: np.asarray(v) for k, v in jbatched(TINY, **kw)(
        jeng.params, jnp.asarray(strain), jnp.asarray(bands), key).items()}
    z = [torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (4, 64, 11)))) for s in range(2)]
    got = {k: v.numpy() for k, v in make_batched_decompose(cfg, **kw)(
        teng.model, strain, bands, z=z).items()}
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got["accepted"], ref["accepted"])
    np.testing.assert_array_equal(got["n_extracted"], ref["n_extracted"])
    assert 0 < int(got["accepted"].sum()) < 8
    assert got["median"].shape == (4, 2, 11)
    ok, err = _close_columns(got["median"], ref["median"])
    assert ok, err
    for k in ("alpha", "quality", "fit_snr", "final_residual"):
        assert _close(got[k], ref[k]), k
    # the sharded form on a one-rank gloo group: bit-equal to the above
    assert init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                            device="cpu") == 1
    try:
        sharded = make_batched_decompose(cfg, mesh=make_mesh(), **kw)(
            teng.model, strain, bands, z=z)
    finally:
        dist.destroy_process_group()
    for k, v in got.items():
        np.testing.assert_array_equal(sharded[k].numpy(), v, err_msg=k)


def test_baselines_order_and_remove_power_as_jax():
    prep = prepare_simulated(TWO, seed=8, add_noise=False, device="cpu")
    cands = np.array([[p[k] for k in PARAM_NAMES] for p in TWO],
                     dtype=np.float32)
    power = float((prep.strain ** 2).sum())
    for t_cls, j_cls in ((tbench.StandardHierarchicalSubtraction,
                          jbench.StandardHierarchicalSubtraction),
                         (tbench.SimpleIterativeSubtraction,
                          jbench.SimpleIterativeSubtraction)):
        got = t_cls(device="cpu").decompose(prep.strain, cands)
        ref = j_cls().decompose(prep.strain, cands)
        assert got["order"] == ref["order"] == [0, 1]
        assert got["extracted"][0]["fit_snr"] > 5.0
        assert got["residual_power"] < 0.01 * power
        assert abs(got["residual_power"] - ref["residual_power"]) \
            <= 1e-3 * power
        for a, b in zip(got["extracted"], ref["extracted"]):
            assert a["fit_snr"] == pytest.approx(b["fit_snr"], rel=1e-3)
    log_l = tbench.JointParameterEstimation(
        device="cpu").make_joint_log_likelihood(prep.strain)
    j_log_l = jbench.JointParameterEstimation().make_joint_log_likelihood(
        prep.strain)
    assert float(log_l(cands)) == pytest.approx(
        float(j_log_l(jnp.asarray(cands))), rel=1e-4)


def test_output_calibrator_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(0, 1, 200)
    t = 2.0 * s + 3.0 + rng.normal(0, 0.1, 200)
    for mode in ("learned", "minmax", "percentile"):
        got = OutputCalibrator().fit(s, t, mode=mode)
        ref = JCal().fit(s, t, mode=mode)
        assert (got.gain, got.bias, got.mode) == (ref.gain, ref.bias,
                                                  ref.mode)
        assert np.abs(got(s) - t).mean() < 0.5
