"""tools/validate_checkpoint.py against scripts/validate_checkpoint.py.

- GATES, REAL_GATE and _check equal the JAX script's (imported from its
  file); _write_html writes the same string on the same report.
- One validation chunk (chunk_metrics: the diagnostics and calibration
  metrics the tool averages) on the conv test config in float32, given
  JAX's batch, permutation and base draws (rebuilt from the JAX script's
  key), against the JAX script's two calls on that key. Tolerances as in
  tests/test_torch_train_eval.py: NLL means 1e-5 relative plus 1e-5,
  dist_corr and base_conc 1e-4; coverages and railing to one event (one
  draw); SBC ranks one step for at most 1% of the entries.
- main end to end on a port checkpoint of that config, on the CPU with a
  two-segment synthetic noise bank, in two chunks of 32 events (the
  tool's chunk of 256, cut to test size): the report's keys, at every level,
  are those of the JAX flagship report reports/val_r7/report.json plus
  n_events_nominal (which the JAX script writes since the rounding up of
  --n-events; that report predates it), every number is finite,
  ood_stats.npz is written beside the checkpoint and the exit code is the
  gates' verdict.
"""

import importlib.util
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from posteriflow_tpu.train import gates as jgates
from posteriflow_tpu.train.diagnostics import make_diagnostics as jdiag
from posteriflow_torch.inference.ood import ContextStats
from posteriflow_torch.tools import make_noise_bank
from posteriflow_torch.tools import validate_checkpoint as vc
from posteriflow_torch.train import gates as tgates
from posteriflow_torch.train.diagnostics import make_diagnostics
from torch_eval_helpers import port_checkpoint
from torch_sim_helpers import one_torch_thread
from torch_train_helpers import (CONFIGS, batches, jax_params, port_config,
                                 port_model, with_dtype)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread):
    a tool run on the CPU takes 5 to 20 times its time when the suite's
    workers each spread its small ops over every core."""


N_EVENTS, N_POST = 16, 32


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_checkpoint", ROOT / "scripts" / "validate_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gates_and_check_match_jax(jscript):
    assert vc.GATES == jscript.GATES
    assert list(vc.GATES) == list(jscript.GATES)
    assert vc.REAL_GATE == jscript.REAL_GATE
    for name, spec in {**vc.GATES, **vc.REAL_GATE}.items():
        thresh = spec[1]
        for value in (thresh - 1e-3, thresh, thresh + 1e-3, 0, np.float32(1)):
            assert vc._check(name, value, spec) == jscript._check(name, value,
                                                                  spec)


def test_write_html_matches_jax(jscript, tmp_path):
    report = json.loads((ROOT / "reports" / "val_r7" / "report.json")
                        .read_text())
    report["checks"][3]["passed"] = False
    report["passed"] = False
    vc._write_html(tmp_path / "port.html", report)
    jscript._write_html(tmp_path / "jax.html", report)
    assert ((tmp_path / "port.html").read_text()
            == (tmp_path / "jax.html").read_text())


def test_chunk_metrics_match_jax():
    jcfg = with_dtype(CONFIGS["conv"], "float32")
    params = jax.device_get(jax_params(jcfg))
    rng = np.random.default_rng(1)
    for cond in params["params"]["flow"].values():
        cond["out"]["kernel"] = (rng.standard_normal(
            cond["out"]["kernel"].shape) * 0.05).astype(np.float32)
    (jb, tb), = batches(jcfg, 1, N_EVENTS, seed=11)
    key = jax.random.fold_in(jax.random.PRNGKey(1234), 3)
    jd = jdiag(jcfg, n_events=N_EVENTS, n_post=N_POST)(params, jb, key)
    jc = jgates.make_calibration_metrics(jcfg, n_events=N_EVENTS,
                                         n_post=N_POST)(params, jb, key)
    k_perm, k_samp = jax.random.split(key)
    p = jcfg.npe.n_params
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm,
                                                              N_EVENTS)))
    z_diag = torch.from_numpy(np.array(
        jax.random.normal(k_samp, (N_EVENTS, N_POST, p))))
    z_cal = torch.from_numpy(np.array(
        jax.random.normal(key, (N_EVENTS, N_POST, p))))
    cfg = port_config(jcfg)
    got = vc.chunk_metrics(
        make_diagnostics(cfg, n_events=N_EVENTS, n_post=N_POST),
        tgates.make_calibration_metrics(cfg, n_events=N_EVENTS,
                                        n_post=N_POST),
        port_model(jcfg, params), tb, perm=perm, z_diag=z_diag, z_cal=z_cal)
    # the JAX script keeps every 0-d output of the diagnostics
    want = {k: float(v) for k, v in jd.items() if v.ndim == 0}
    assert got["diag"].keys() == want.keys()
    for k in ("val_nll_diag", "shuffle_delta_nll"):
        assert abs(got["diag"][k] - want[k]) <= 1e-5 * abs(want[k]) + 1e-5
    assert abs(got["diag"]["dist_corr"] - want["dist_corr"]) <= 1e-4
    live = np.asarray(jc["live_mask"])
    n_live = max(live.sum(), 1.0)
    np.testing.assert_array_equal(got["live"], live)
    for k in ("dist_cov50", "dist_cov90"):
        assert abs(got["diag"][k] - want[k]) <= 1.0 / n_live + 1e-6
    assert np.abs(got["cov50"] - np.asarray(jd["cov50_all"])).max() \
        <= 1.0 / n_live + 1e-6
    assert np.abs(got["cov90"] - np.asarray(jc["cov90_all"])).max() \
        <= 1.0 / n_live + 1e-6
    assert abs(got["spurious_railing"] - float(jc["spurious_railing"])) \
        <= 1.0 / (n_live * N_POST)
    assert abs(got["base_conc"] - float(jc["base_conc"])) \
        <= 1e-4 * float(jc["base_conc"])
    d = np.abs(got["ranks"] - np.asarray(jc["sbc_ranks"]))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def _keys(report: dict) -> dict:
    """The key sets of a report at every level."""
    m = report["metrics"]
    return {"top": set(report), "metrics": set(m), "meta": set(report["_meta"]),
            "checks": {frozenset(c) for c in report["checks"]},
            "gates": [c["gate"] for c in report["checks"]],
            "smoke": {frozenset(t) for t in m["smoke_tests"]},
            "smoke_params": {frozenset(t["params"]) for t in m["smoke_tests"]},
            "ood_live": {frozenset(c) for c in m["ood_live"]},
            "ood_cases": [c["case"] for c in m["ood_live"]],
            "glitch": {frozenset(c) for c in m["glitch_signal"]}}


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def test_main_on_a_tiny_checkpoint_writes_jax_report_keys(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(vc, "CHUNK", 32)      # the tool's 256, at test size
    cfg = port_config(CONFIGS["conv"])
    root = port_checkpoint(tmp_path / "run", "conv")
    bank = tmp_path / "bank"
    make_noise_bank.main(["--out", str(bank), "--synthetic", "2"])
    code = vc.main(["--ckpt", str(root), "--n-events", "40", "--n-post",
                    "8", "--noise-bank", str(bank), "--device", "cpu"])
    out = tmp_path / "run" / "validation"        # JAX's default --out
    report = json.loads((out / "report.json").read_text())
    assert (out / "report.html").read_text().startswith("<html>")
    assert code == (0 if report["passed"] else 1)

    ref = json.loads((ROOT / "reports" / "val_r7" / "report.json")
                     .read_text())
    got, want = _keys(report), _keys(ref)
    assert got.pop("metrics") == want.pop("metrics") | {"n_events_nominal"}
    assert got == want
    m = report["metrics"]
    assert set(m["cov50_all"]) == set(cfg.npe.param_names)
    # rounded up to whole chunks, as JAX does
    assert (m["n_events"], m["n_events_nominal"], m["n_post"]) == (64, 40, 8)
    assert all(math.isfinite(v) for v in _numbers(report))
    assert report["_meta"]["config_hash"]

    stats = ContextStats.load(root / "ood_stats.npz")
    c = cfg.npe.context_dim
    assert stats.mean.shape == (c,) and stats.precision.shape == (c, c)
    assert stats.val_dists.shape == (64,)
    assert np.all(np.diff(stats.val_dists) >= 0)
