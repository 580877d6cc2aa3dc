"""The port's serving layer against posteriflow_tpu: prepare_real, the
scaler, OOD scoring, the refinement gate, PosteriorResult, and the
InferenceEngine on a small release written by the JAX package (encode and
sample_posterior fed the draws JAX takes from its key)."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_bytes

from posteriflow_tpu.inference import gating as jgating
from posteriflow_tpu.inference import ood as jood
from posteriflow_tpu.inference import pipeline as jpipe
from posteriflow_tpu.inference.preprocessing import prepare_real as jprep
from posteriflow_tpu.inference.result import PosteriorResult as JResult
from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.models.npe import NPEConfig as JCfg
from posteriflow_tpu.scaler import ParamScaler as JScaler
from posteriflow_tpu.train.checkpoints import _cfg_to_dict
from posteriflow_tpu.train.trainer import TrainConfig
from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import gating as tgating
from posteriflow_torch.inference import ood as tood
from posteriflow_torch.inference import pipeline as tpipe
from posteriflow_torch.inference.preprocessing import prepare_real as tprep
from posteriflow_torch.inference.result import PosteriorResult as TResult
from posteriflow_torch.physics.psd import psd_for
from posteriflow_torch.scaler import ParamScaler as TScaler

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "model_release" / "npe_r7_best"


def _raw_noise(seed, seconds=16.0, fs=4096, dets=("H1", "L1", "V1")):
    """{det: raw strain} of Gaussian noise coloured by the design PSD."""
    n = int(seconds * fs)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    rng = np.random.default_rng(seed)
    out = {}
    for d in dets:
        amp = np.sqrt(n * fs * psd_for(d, f) / 4.0)
        out[d] = np.fft.irfft(amp * (rng.standard_normal(f.size)
                                     + 1j * rng.standard_normal(f.size)), n=n)
    return out


def test_prepare_real_matches_jax():
    """Same numpy/scipy code: identical arrays. V1 missing (filled with the
    seeded unit noise), an ASD override for L1, a glitch in H1."""
    raw = _raw_noise(0, dets=("H1", "L1"))
    raw["H1"][30000] += 1e-18
    override = {"L1": np.sqrt(psd_for("L1"))}
    j = jprep(raw, gps_time=5.0, psd_bands=16, asd_by_det=override)
    t = tprep(raw, gps_time=5.0, psd_bands=16, asd_by_det=override)
    for name in ("strain", "asds", "asd_bands"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.detectors_present == j.detectors_present == ["H1", "L1"]
    assert t.warnings == j.warnings and t.quality == j.quality
    assert t.gps_time == j.gps_time == 5.0


def test_scaler_matches_jax():
    """float32 on both sides: rtol 1e-6 (log/exp rounding)."""
    names = PARAM_NAMES_PRECESSING
    js, ts = JScaler(names), TScaler(names)
    rng = np.random.default_rng(1)
    y = rng.uniform(-1.6, 1.6, (64, len(names))).astype(np.float32)
    phys = np.array(js.denormalize(jnp.asarray(y)))
    pairs = [
        (js.normalize(jnp.asarray(phys)), ts.normalize(torch.from_numpy(phys))),
        (js.denormalize(jnp.asarray(y)), ts.denormalize(torch.from_numpy(y))),
        (js.wrap(jnp.asarray(y)), ts.wrap(torch.from_numpy(y))),
        (js.log_abs_det_jacobian(jnp.asarray(phys)),
         ts.log_abs_det_jacobian(torch.from_numpy(phys))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(ts.railing_mask(torch.from_numpy(y)).numpy(),
                                  np.asarray(js.railing_mask(jnp.asarray(y))))


def test_ood_and_gate_match_jax():
    js = jood.ContextStats.load(FLAGSHIP / "ood_stats.npz")
    ts = tood.ContextStats.load(FLAGSHIP / "ood_stats.npz")
    ctx = np.random.default_rng(2).standard_normal((5, js.mean.size))
    for a, b in zip(tood.score_context(ts, ctx), jood.score_context(js, ctx)):
        np.testing.assert_array_equal(a, b)
    for args in [(10.0, 0.0, []), (96.0, 0.06, ["w"]), (99.5, 0.3, [])]:
        assert tood.confidence_verdict(*args) == jood.confidence_verdict(*args)
    assert tgating.load_bias_map() == jgating.load_bias_map()
    rng = np.random.default_rng(3)
    samples = np.abs(rng.normal([30.0, 15.0] + [1.0] * 13, 5.0, (400, 15)))
    for verdict in ("HIGH", "MEDIUM", "LOW"):
        t = tgating.refinement_gate(verdict, 99.2, 0.07, samples,
                                    tgating.load_bias_map())
        j = jgating.refinement_gate(verdict, 99.2, 0.07, samples,
                                    jgating.load_bias_map())
        assert t == j


def test_result_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    samples = np.abs(rng.normal(10.0, 3.0, (200, 15)))
    lp = rng.normal(size=200)
    railed = rng.uniform(size=200) < 0.1
    kw = dict(samples=samples, log_prob=lp, railed=railed,
              param_names=PARAM_NAMES_PRECESSING, rank=1, verdict="MEDIUM")
    t, j = TResult(**kw), JResult(**kw)
    for name in ("median", "mean", "map_estimate", "credible_interval",
                 "covariance", "correlation", "railing_fraction"):
        np.testing.assert_array_equal(getattr(t, name)(), getattr(j, name)())
    assert t.summary() == j.summary()
    (tw, tess), (jw, jess) = (t.reweight_to_uniform_masses(),
                              j.reweight_to_uniform_masses())
    np.testing.assert_array_equal(tw.weights, jw.weights)
    assert tess == jess
    out = t.save(tmp_path / "res")
    assert (out / "samples.npy").exists() and (out / "result.json").exists()
    doc = json.loads(t.save_bilby(tmp_path / "res.json").read_text())
    assert doc["meta_data"]["framework"] == "posteriflow_torch"


SMALL = dict(context_dim=24, rank_dim=8, flow_layers=2, flow_hidden=32,
             flow_bins=4, d_model=32, enc_layers=1, enc_heads=4,
             psd_cond=True, encoder_dtype="float32", flow_dtype="float32")


@pytest.fixture(scope="module")
def small_release(tmp_path_factory):
    """An 11-D coherent release written the way the JAX package writes one
    (flax bytes + meta.json + ood_stats.npz), flow moved off its init."""
    cfg = TrainConfig(npe=JCfg(**SMALL))
    model = JNPE(cfg.npe)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16384)),
        jnp.full((1, 11), 1.5), jnp.zeros(1, jnp.int32),
        jnp.zeros((1, 3, 16))))
    rng = np.random.default_rng(5)
    params["params"]["flow"] = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        params["params"]["flow"])
    d = tmp_path_factory.mktemp("release")
    (d / "params.msgpack").write_bytes(to_bytes(params))
    (d / "meta.json").write_text(json.dumps({"config": _cfg_to_dict(cfg)}))
    ctx = rng.standard_normal((50, SMALL["context_dim"]))
    jood.ContextStats(ctx.mean(0), np.eye(ctx.shape[1]),
                      np.sort(rng.uniform(0, 8, 50))).save(d / "ood_stats.npz")
    return d


def test_engine_matches_jax_engine(small_release):
    jeng = jpipe.InferenceEngine.from_checkpoint(small_release)
    teng = tpipe.InferenceEngine.from_checkpoint(small_release, device="cpu")
    prep = tprep(_raw_noise(6), psd_bands=16)
    jctx = np.array(jeng.encode(jnp.asarray(prep.strain[None]),
                                jnp.asarray(prep.asd_bands[None])))
    tctx = teng.encode(prep.strain[None], prep.asd_bands[None]).numpy()
    np.testing.assert_allclose(tctx, jctx, atol=2e-4 * np.abs(jctx).max())

    key, n = jax.random.PRNGKey(9), 128
    jt, jlq, jr = (np.asarray(a) for a in
                   jeng.sample_posterior(key, jnp.asarray(jctx), 1, n))
    z = torch.from_numpy(np.array(jax.random.normal(key, (1, n, 11))))
    tt, tlq, tr = (a.numpy() for a in teng.sample_posterior(
        torch.from_numpy(jctx), 1, n, z=z))
    assert (tt[..., 0] >= tt[..., 1]).all()
    np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlq, jlq, atol=1e-3)
    np.testing.assert_array_equal(tr, jr)


def test_infer_and_overlapping_on_cpu(small_release):
    eng = tpipe.load_model(small_release, device="cpu")
    assert tpipe.load_model(small_release, device="cpu") is eng
    res = tpipe.infer(eng, strain=_raw_noise(7), rank=0, n_samples=32)
    assert res.samples.shape == (32, 11) and np.isfinite(res.samples).all()
    assert np.isfinite(res.log_prob).all()
    assert (res.samples[:, 0] >= res.samples[:, 1]).all()
    assert res.verdict in ("HIGH", "MEDIUM", "LOW") and "refine" in res.gate
    assert res.diagnostics["device"] == "cpu"
    again = tpipe.infer(eng, strain=_raw_noise(7), rank=0, n_samples=32)
    np.testing.assert_array_equal(again.samples, res.samples)   # seeded
    both = tpipe.infer_overlapping(eng, strain=_raw_noise(8), n_signals=2,
                                   n_samples=16)
    assert [r.rank for r in both] == [0, 1]
    with pytest.raises(ValueError):
        tpipe.infer(eng)
    assert dataclasses.asdict(eng.cfg)["param_names"][0] == "mass_1"
