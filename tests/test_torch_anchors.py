"""The nested-sampler anchors of the port against the JAX package:
tools/make_anchors.py, tools/anchor_convergence.py and
tools/evidence_validation.py.

Exact: the anchors' injections and seeds (scripts/make_anchors.py), the
likelihood wrapper `_chunked` as tests/test_anchor_convergence.py holds
JAX's, the analytic truths, the matched-proposal IS evidences (numpy
throughout, and sample_prior_bbh draws JAX's numbers from the same
default_rng: held to analysis/evidence_validation.json within 1e-9) and
the fallback nested sampler on the 15-D synthetic likelihood (the same
numpy stream; within 1e-9 of the report, and so within 1 nat of the
truth). The tools' reports keep every key of the JAX reports; the slow
samplers are replaced by stand-ins where only the report is checked.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from posteriflow_torch.tools import anchor_convergence as ac
from posteriflow_torch.tools import evidence_validation as ev
from posteriflow_torch.tools import make_anchors as ma
from torch_sim_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
REPORT = json.loads((ROOT / "analysis" / "evidence_validation.json")
                    .read_text())
ANCHORS = json.loads((ROOT / "analysis" / "anchors.json").read_text())
EXACT = 1e-9


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _spy_log_l(seen):
    def log_l(theta):
        seen.append(theta.shape[0])
        return np.sum(theta, axis=-1)
    return log_l


def test_chunked_exact_and_shape_canonical():
    rng = np.random.default_rng(0)
    seen = []
    wrapped = ac._chunked(_spy_log_l(seen))
    for n in (24, 400, 401, 799, 1600):
        theta = rng.normal(size=(n, 15)).astype(np.float32)
        np.testing.assert_allclose(wrapped(theta), np.sum(theta, axis=-1),
                                   rtol=1e-6)
    assert set(seen) <= {24, ac.CHUNK}, seen


def test_chunked_pads_with_first_row():
    seen = []
    wrapped = ac._chunked(_spy_log_l(seen), chunk=8, small=2)
    theta = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_allclose(wrapped(theta), theta.sum(-1))
    assert seen == [8]


def test_grid_and_anchors_equal_the_jax_scripts():
    import anchor_convergence as j_ac
    import make_anchors as j_ma
    assert ac.GRID == j_ac.GRID and ac.CHUNK == j_ac.CHUNK
    assert ma.ANCHORS == j_ma.ANCHORS and ma._BASE == j_ma._BASE


@pytest.mark.parametrize("n_params", [11, 15])
def test_injections_and_seeds_equal_jax(n_params):
    import make_anchors as j_ma
    from posteriflow_torch import PARAM_NAMES_PRECESSING
    names = PARAM_NAMES_PRECESSING[:n_params]
    for spec in ma.ANCHORS:
        assert ma._seed_of(spec["name"]) == j_ma._seed_of(spec["name"])
        assert ma._injection_params(spec, names) == \
            j_ma._injection_params(spec, names)
    if n_params == 15:                    # the committed report's
        for name, entry in ANCHORS["anchors"].items():
            spec = next(s for s in ma.ANCHORS if s["name"] == name)
            assert ma._injection_params(spec, names) == entry["injected"]


def _fake_comparison(calls):
    def run_comparison(engine, prepared, **kw):
        calls.append((prepared.strain.shape, kw))
        one = ANCHORS["anchors"]["low_mc_razor"][
            "comparison_npe_vs_sampler"]["mass_1"]
        comp = {n: dict(one) for n in engine.cfg.param_names
                if n not in ("phase", "geocent_time")}
        return {"comparison": comp, "is_comparison": comp,
                "is": {"ess": 10.0, "efficiency": 0.5, "n_stages": 2,
                       "logz": 5.0, "t_is_s": 0.1},
                "logz_gap": 1.0, "t_npe_s": 0.2, "t_nested_s": 0.3,
                "nested": {"logz": 4.0, "sampler": "fallback-nested",
                           "n_like_calls": 100}}
    return run_comparison


def test_make_anchors_report_resume_and_hash_refusal(tmp_path,
                                                     monkeypatch):
    from posteriflow_torch.inference import dynesty_bridge
    calls = []
    monkeypatch.setattr(dynesty_bridge, "run_comparison",
                        _fake_comparison(calls))
    out = tmp_path / "anchors.json"
    argv = ["--device", "cpu", "--out", str(out), "--n-samples", "30",
            "--nlive", "40", "--maxiter", "240"]
    rep = ma.main(argv + ["--only", "low_mc_razor"])
    assert set(rep) == set(ANCHORS) - {"sampler_self_consistency"}
    assert rep["_meta"]["config_hash"] == ANCHORS["_meta"]["config_hash"]
    entry = rep["anchors"]["low_mc_razor"]
    assert set(entry) == set(ANCHORS["anchors"]["low_mc_razor"])
    assert calls[0][1] == dict(n_samples=30, nlive=40, maxiter=240,
                               importance=True, sampler="nested")
    assert calls[0][0] == (3, 16384)
    # resume: the finished anchor is kept, the next one added
    rep = ma.main(argv + ["--only", "low_mc_razor,high_mc"])
    assert list(rep["anchors"]) == ["low_mc_razor", "high_mc"]
    assert len(calls) == 2
    # an output of another model is refused
    other = json.loads(out.read_text())
    other["_meta"]["config_hash"] = "000000000000"
    out.write_text(json.dumps(other))
    with pytest.raises(SystemExit, match="refusing to mix"):
        ma.main(argv)


def test_self_check_report_keys(tmp_path, monkeypatch):
    from posteriflow_torch.inference import dynesty_bridge
    rng = np.random.default_rng(0)

    def run_dynesty(log_l, nlive, seed, maxiter, ndim):
        theta = rng.uniform(0.5, 1.5, (200, ndim))
        return {"samples": theta, "weights": np.full(200, 1 / 200),
                "logz": float(seed), "n_like_calls": 7}
    monkeypatch.setattr(dynesty_bridge, "run_dynesty", run_dynesty)
    rep = ma.main(["--device", "cpu", "--out", str(tmp_path / "s.json"),
                   "--self-check", "gw150914_like", "--nlive", "40"])
    sc, ref = rep["sampler_self_consistency"], \
        ANCHORS["sampler_self_consistency"]
    assert set(sc) == set(ref)
    assert [r["seed"] for r in sc["runs"]] == [r["seed"] for r in ref["runs"]]
    assert sc["logz_gap_run0_minus_run1"] == 11 - 1011


def test_anchor_convergence_report_and_resume(tmp_path, monkeypatch):
    """The study's report, with the flow-IS block and the nested runs
    replaced by stand-ins; the stand-in sampler calls the real likelihood
    once through _chunked on the CPU."""
    from posteriflow_torch.inference import dynesty_bridge
    ref = json.loads((ROOT / "analysis" / "anchor_convergence.json")
                     .read_text())
    monkeypatch.setattr(ac, "flow_is_block", lambda *a, **k: {
        "logz": 3.0, "ess": 1.0, "efficiency": 0.5, "n_stages": 1,
        "t_s": 0.0})
    walked = []

    def nested(log_l, nlive, dlogz, seed, maxiter, walks, ndim):
        from posteriflow_torch.inference.dynesty_bridge import \
            prior_transform
        theta = prior_transform(np.random.default_rng(seed).uniform(
            size=(24, ndim))).astype(np.float32)
        walked.append(np.asarray(log_l(theta)))
        return {"logz": 1.0, "n_like_calls": nlive * walks}
    monkeypatch.setattr(dynesty_bridge, "_nested_fallback", nested)
    out = tmp_path / "conv.json"
    rep = ac.main(["--device", "cpu", "--out", str(out), "--grid", "0"])
    # today's anchors.json asym_q, as the JAX script reads it (the
    # committed study ran on an earlier anchors.json's tilts)
    assert set(rep) == set(ref)
    assert rep["injected"] == ANCHORS["anchors"]["asym_q"]["injected"]
    assert set(rep["runs"][0]) == set(ref["runs"][0])
    assert rep["runs"][0]["gap_vs_is"] == 2.0
    assert walked[0].shape == (24,) and np.isfinite(walked[0]).all()
    rep = ac.main(["--device", "cpu", "--out", str(out), "--grid", "0",
                   "1"])
    assert [(r["nlive"], r["walks"]) for r in rep["runs"]] == \
        [g[:2] for g in ac.GRID[:2]]
    assert len(walked) == 2


@pytest.mark.parametrize("part", ["synthetic", "synthetic_15d"])
def test_truths_and_matched_is_equal_the_report(part):
    ref = REPORT[part]
    truth = ev._truth_logz() if part == "synthetic" else ev._truth_logz_15()
    assert abs(truth - ref["truth_logz"]) <= EXACT
    from posteriflow_torch.prior import PriorConfig
    if part == "synthetic":
        dims = [(d, mu, sig, lo, hi, "uniform") for d, mu, sig, (lo, hi)
                in zip(ev._L_DIMS, ev._MU, ev._SIG, ev._BOX)]
        pcfg, log_l = PriorConfig(), ev.synthetic_log_l
    else:
        dims = [(d, *v) for d, v in ev._L15.items()]
        pcfg, log_l = PriorConfig(precessing=True), ev.synthetic_log_l_15
    got = ev._matched_is(np.random.default_rng(0), 4096, 3, pcfg, dims,
                         log_l, truth)
    for k in ("logz_mean", "logz_std", "bias"):
        assert abs(got[k] - ref["is_good_proposal"][k]) <= EXACT, k


def test_nested_sampler_on_the_15d_truth():
    """The fallback nested sampler at nlive 400 on the 15-D synthetic
    likelihood: the JAX report's run, within 1 nat of the truth."""
    from posteriflow_torch.inference.dynesty_bridge import run_dynesty
    r = run_dynesty(ev.synthetic_log_l_15, nlive=400, seed=0,
                    maxiter=200000, ndim=15)
    ref = REPORT["synthetic_15d"]["nested_vs_nlive"][0]
    assert ref["nlive"] == 400
    assert abs(r["logz"] - ref["logz"]) <= EXACT
    assert r["n_like_calls"] == ref["n_like_calls"]
    assert abs(r["logz"] - ev._truth_logz_15()) <= 1.0


def test_evidence_validation_tool_report(tmp_path):
    """The tool at 512 particles on the CPU: JAX's report keys, the
    matched-proposal IS within 0.05 nats of the truth and prior-SMC at
    n_mcmc 30 within 1 nat (a twentieth of JAX's 4096 particles)."""
    rep = ev.main(["--n", "512", "--device", "cpu", "--out",
                   str(tmp_path / "ev.json")])
    for part in ("synthetic", "synthetic_15d"):
        assert set(rep[part]) == set(REPORT[part])
        assert abs(rep[part]["is_good_proposal"]["bias"]) <= 0.05
        rows = rep[part]["prior_smc_vs_walk_length"]
        assert [r["n_mcmc"] for r in rows] == [1, 3, 10, 30]
        assert abs(rows[-1]["bias"]) <= 1.0
    assert [r["nlive"] for r in rep["synthetic_15d"]["nested_vs_nlive"]] \
        == [400, 800]
    assert json.loads((tmp_path / "ev.json").read_text())["_meta"][
        "device"] == "cpu"
