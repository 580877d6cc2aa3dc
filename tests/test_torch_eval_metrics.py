"""The port's evaluation layer against the JAX package, numpy in and out:
provenance (config_hash, artifact_meta, check_artifact_matches), the
metric classes (BiasMetrics, PerformanceMetrics, RecoveryMetrics,
ComparisonMetrics.compare_methods), ResultValidator and NoiseAnalyzer.

Inputs are drawn from seeded numpy generators and fed to both packages.
Both compute in float64 numpy and scipy with the same expressions, so the
outputs are held equal: every float within 1e-12 relative (plus 1e-12),
every other value exactly.
"""

import math
from pathlib import Path

import numpy as np
import pytest

from posteriflow_tpu.evaluation import metrics as JM
from posteriflow_tpu.evaluation.noise_analysis import NoiseAnalyzer as JNoise
from posteriflow_tpu.evaluation.validation import ResultValidator as JValid
from posteriflow_tpu.inference.result import PosteriorResult as JResult
from posteriflow_tpu.utils import provenance as JP
from posteriflow_torch.evaluation import (BiasMetrics, ComparisonMetrics,
                                          NoiseAnalyzer, PerformanceMetrics,
                                          RecoveryMetrics, ResultValidator)
from posteriflow_torch.inference.result import PosteriorResult
from posteriflow_torch.utils import provenance as TP
from torch_eval_helpers import port_checkpoint

ROOT = Path(__file__).resolve().parents[1]
RELEASE = ROOT / "model_release" / "npe_r7_best"
REL = 1e-12


def assert_same(got, want, path="out"):
    """Recursive equality, floats within REL relative plus REL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)) and not isinstance(
            want, bool):
        if math.isnan(want) or math.isinf(want):
            assert got == want or (math.isnan(want) and math.isnan(got)), path
        else:
            assert abs(got - want) <= REL * abs(want) + REL, (path, got,
                                                               want)
    else:
        assert got == want, (path, got, want)


def _no_time(meta: dict) -> dict:
    return {k: v for k, v in meta.items() if k != "generated_utc"}


# ── provenance ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("seed", [0, 1])
def test_config_hash_matches_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = {"npe": {"layers": int(rng.integers(1, 20)),
                   "names": ["a", "b"], "lr": float(rng.random())},
           "sim": {"snr": float(rng.random()), "on": bool(seed)}}
    assert TP.config_hash(cfg) == JP.config_hash(cfg)


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A port training checkpoint root of the conv test config."""
    return port_checkpoint(tmp_path_factory.mktemp("ckpt"), "conv")


def test_artifact_meta_matches_jax(port_ckpt):
    """On the release (b58b05b3ce29, the hash the JAX reports record), on a
    port checkpoint's entry and root, and on a path with no meta.json."""
    for ckpt in (RELEASE, port_ckpt / "best", port_ckpt, port_ckpt / "x"):
        got = TP.artifact_meta(ckpt, param_names=["a"], warmup_s=1.5)
        want = JP.artifact_meta(ckpt, param_names=["a"], warmup_s=1.5)
        assert _no_time(got) == _no_time(want)
        assert got["generated_utc"][:13] == want["generated_utc"][:13]
    assert TP.artifact_meta(RELEASE)["config_hash"] == "b58b05b3ce29"
    assert "config_hash" in TP.artifact_meta(port_ckpt)


def _raised(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def test_check_artifact_matches_raises_where_jax_raises(port_ckpt,
                                                        tmp_path):
    good = JP.artifact_meta(RELEASE)
    bad = dict(good, config_hash="000000000000")
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "meta.json").write_text("{not json")
    cases = [(None, RELEASE), ({}, RELEASE), ({"ckpt": "x"}, RELEASE),
             (good, RELEASE), (bad, RELEASE), (bad, port_ckpt),
             (good, tmp_path / "none"), (bad, broken)]
    outcomes = []
    for block, release in cases:
        got = _raised(TP.check_artifact_matches, block, release, "bias map")
        want = _raised(JP.check_artifact_matches, block, release,
                       "bias map")
        assert got == want
        outcomes.append(got is not None)
    assert outcomes == [True, True, True, False, True, True, False, False]


# ── metrics ───────────────────────────────────────────────────────────────

def _events(seed: int, n: int = 40, p: int = 11):
    rng = np.random.default_rng(seed)
    truth = np.column_stack([rng.uniform(20, 60, n), rng.uniform(5, 20, n),
                             rng.uniform(200, 2000, n),
                             rng.uniform(0, 6, (n, p - 3))])
    est = truth * (1 + 0.05 * rng.standard_normal((n, p))) + 0.01
    std = np.abs(truth) * rng.uniform(0.01, 0.2, (n, p))
    return est, truth, std


@pytest.mark.parametrize("with_std", [False, True])
def test_bias_metrics_match_jax(with_std):
    est, truth, std = _events(3)
    stds = std if with_std else None
    got = BiasMetrics().compute(est, truth, stds)
    want = JM.BiasMetrics().compute(est, truth, stds)
    assert_same(got, want)
    assert_same(BiasMetrics.overall(got), JM.BiasMetrics.overall(want))
    assert BiasMetrics.overall({}) == {}


def test_performance_metrics_match_jax():
    rng = np.random.default_rng(4)
    got, want = PerformanceMetrics(), JM.PerformanceMetrics()
    assert got.summary() == want.summary() == {}
    for _ in range(7):
        kw = dict(wall_time_s=float(rng.uniform(0.1, 3)),
                  n_samples=int(rng.integers(100, 5000)),
                  accuracy_score=float(rng.uniform(0.3, 1.0)), tag="x")
        got.record(**kw)
        want.record(**kw)
    assert_same(got.summary(), want.summary())
    assert got.records == want.records
    for sizes, thr in (([8, 1, 64, 16], [900.0, 1000.0, 300.0, 700.0]),
                       ([2, 4], [10.0, 25.0]), ([1, 2, 3], [5.0, 3.0, 1.0])):
        assert_same(PerformanceMetrics.scalability(sizes, thr),
                    JM.PerformanceMetrics.scalability(sizes, thr))


@pytest.mark.parametrize("seed", [5, 6])
def test_recovery_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    inj, _, _ = _events(seed, n=5)
    inj[:, 8] = rng.uniform(-0.1, 0.1, 5)
    rec = inj[[3, 0, 4]] * (1 + 0.03 * rng.standard_normal((3, 11)))
    rec = np.vstack([rec, inj[1] * 2.5])          # one spurious recovery
    stds = np.abs(rec) * 0.05
    for kw in ({}, {"mc_tol": 0.05, "time_tol": 0.01}):
        assert_same(RecoveryMetrics(**kw).match(rec, inj),
                    JM.RecoveryMetrics(**kw).match(rec, inj))
    for std in (None, stds[0]):
        assert_same(RecoveryMetrics.match_score(rec[0], inj[3], std),
                    JM.RecoveryMetrics.match_score(rec[0], inj[3], std))
    for rec_stds in (None, stds):
        got = RecoveryMetrics().match_soft(rec, inj, rec_stds)
        want = JM.RecoveryMetrics().match_soft(rec, inj, rec_stds)
        assert_same(got, want)
        loud = rng.uniform(8, 30, 5)
        for loudness in (None, loud):
            assert_same(RecoveryMetrics.failure_analysis(got, inj, loudness),
                        JM.RecoveryMetrics.failure_analysis(want, inj,
                                                            loudness))
    empty = RecoveryMetrics().match_soft(rec[:1] * 10, inj)
    assert_same(RecoveryMetrics.failure_analysis(empty, inj),
                JM.RecoveryMetrics.failure_analysis(
                    JM.RecoveryMetrics().match_soft(rec[:1] * 10, inj), inj))


def test_compare_methods_matches_jax():
    rng = np.random.default_rng(7)
    acc = rng.uniform(0.4, 0.9, 8)
    methods = {
        "npe": {"accuracy": acc.tolist(),
                "wall_time_s": rng.uniform(0.1, 0.3, 8).tolist()},
        "smc": {"accuracy": (acc + rng.normal(0.05, 0.02, 8)).tolist(),
                "wall_time_s": rng.uniform(10, 30, 8).tolist()},
        "same": {"accuracy": acc.tolist(), "wall_time_s": [1.0] * 8},
        "short": {"accuracy": [0.5, 0.6], "wall_time_s": [2.0, 2.0]},
        "empty": {},
    }
    assert_same(ComparisonMetrics().compare_methods(methods),
                JM.ComparisonMetrics().compare_methods(methods))
    tie = {"a": {"accuracy": [0.5, 0.5, 0.5, 0.5],
                 "wall_time_s": [1.0] * 4},
           "b": {"accuracy": [0.6, 0.4, 0.5, 0.5],
                 "wall_time_s": [1.0] * 4}}
    assert_same(ComparisonMetrics().compare_methods(tie),
                JM.ComparisonMetrics().compare_methods(tie))


# ── ResultValidator, NoiseAnalyzer ────────────────────────────────────────

def _result_cases():
    rng = np.random.default_rng(8)
    names = ("mass_1", "mass_2", "luminosity_distance", "ra", "dec",
             "theta_jn", "psi", "phase", "geocent_time", "a1", "a2")
    good = np.column_stack([rng.uniform(30, 40, 200), rng.uniform(10, 20, 200),
                            rng.uniform(300, 600, 200), rng.uniform(0, 6, 200),
                            rng.uniform(-1, 1, 200), rng.uniform(0, 3, 200),
                            rng.uniform(0, 3, 200), rng.uniform(0, 6, 200),
                            rng.uniform(-0.05, 0.05, 200),
                            rng.uniform(0, 0.9, 200),
                            rng.uniform(0, 0.9, 200)])
    bad = good.copy()
    bad[0, 1] = 99.0                       # m1 < m2
    bad[1, 2] = 1e5                        # distance out of range
    bad[2, 4] = np.nan
    flat = good.copy()
    flat[:, 9] = 0.3
    lp = rng.standard_normal(200)
    lp_bad = lp.copy()
    lp_bad[5] = np.inf
    w = rng.uniform(0, 1, 200)
    return [dict(samples=good), dict(samples=good[:, :10]),
            dict(samples=bad), dict(samples=flat),
            dict(samples=good, log_prob=lp_bad),
            dict(samples=good, log_prob=lp, weights=w / w.sum()),
            dict(samples=good, weights=w)], names


def test_result_validator_matches_jax():
    cases, names = _result_cases()
    for kw in cases:
        got = ResultValidator().validate(PosteriorResult(**kw))
        want = JValid().validate(JResult(**kw))
        assert got == want
    assert ResultValidator().validate(PosteriorResult(**cases[0]))["valid"]


@pytest.mark.parametrize("kind", ["white", "lines"])
def test_noise_analyzer_matches_jax(kind):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(16384)
    if kind == "lines":
        t = np.arange(16384) / 4096.0
        for f0 in (60.0, 120.0, 300.5, 500.0):
            x += 3.0 * np.sin(2 * np.pi * f0 * t)
        x *= np.linspace(0.5, 2.0, 16384)
        x += rng.standard_t(3, 16384)
    assert_same(NoiseAnalyzer().analyze(x), JNoise().analyze(x))
