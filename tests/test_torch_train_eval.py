"""The port's per-epoch evaluation against the JAX package on the CPU:
diagnostics (shuffle-ΔNLL, dist_corr, coverage) and the calibration
gate's device metrics on the same batch, parameters, permutation and base
draws (JAX's, rebuilt from its keys); sbc_pass_frac,
CalibrationGate.passes and select_best on the same inputs;
fit_context_stats against JAX's (sklearn's LedoitWolf); and _merge_params
from an 11-D release into the 15-D flagship config.

Tolerances (float32 flow and encoder): the NLL means to 1e-5 relative
plus 1e-5, dist_corr and base_conc to 1e-4; coverages and the railing
fraction are counts of events or draws against quantiles of the draws,
held to one event (or one draw) in either direction; SBC ranks to one
step for at most 1% of the entries. Measured: the NLL means within 1.5e-7
relative, base_conc 2e-7, and the coverages, railing and ranks equal.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from posteriflow_tpu.inference.ood import fit_context_stats as jfit_stats
from posteriflow_tpu.train import gates as jgates
from posteriflow_tpu.train.checkpoints import cfg_from_dict as jcfg_from_dict
from posteriflow_tpu.train.diagnostics import make_diagnostics as jdiag
from posteriflow_tpu.train.loop import _merge_params as jmerge
from posteriflow_tpu.train.trainer import init_state as jinit_state
from posteriflow_torch.inference.ood import fit_context_stats
from posteriflow_torch.models.npe import LeanNPE as TNPE
from posteriflow_torch.train import gates as tgates
from posteriflow_torch.train.checkpoints import load_release
from posteriflow_torch.train.diagnostics import make_diagnostics
from posteriflow_torch.train.loop import _merge_params
from posteriflow_torch.utils.config import load_config
from torch_train_helpers import (CONFIGS, batches, jax_params, port_config,
                                 port_model, with_dtype)

ROOT = Path(__file__).resolve().parents[1]
N_EVENTS, N_POST = 16, 32


@pytest.fixture(scope="module")
def setup():
    """The conv config in float32, JAX's parameters with the conditioners'
    zero output projections replaced by N(0, 0.05²) (so that the flow is
    not the identity), one batch of 16 events."""
    jcfg = with_dtype(CONFIGS["conv"], "float32")
    params = jax.device_get(jax_params(jcfg))
    rng = np.random.default_rng(0)
    flow = params["params"]["flow"]
    for name, cond in flow.items():
        cond["out"]["kernel"] = (rng.standard_normal(
            cond["out"]["kernel"].shape) * 0.05).astype(np.float32)
    (jb, tb), = batches(jcfg, 1, N_EVENTS, seed=8)
    return jcfg, params, jb, tb, port_model(jcfg, params)


def _close(a, b, rel, abs_=0.0):
    return abs(a - b) <= rel * abs(b) + abs_


def test_diagnostics_match_jax(setup):
    jcfg, params, jb, tb, model = setup
    key = jax.random.PRNGKey(5)
    ref = jdiag(jcfg, n_events=N_EVENTS, n_post=N_POST)(params, jb, key)
    k_perm, k_samp = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, N_EVENTS))
    z = np.asarray(jax.random.normal(k_samp, (N_EVENTS, N_POST,
                                              jcfg.npe.n_params)))
    got = make_diagnostics(port_config(jcfg), n_events=N_EVENTS,
                           n_post=N_POST)(model, tb,
                                          perm=torch.from_numpy(perm),
                                          z=torch.from_numpy(z))
    for k in ("val_nll_diag", "shuffle_delta_nll"):
        assert _close(got[k], float(ref[k]), 1e-5, 1e-5), k
    assert _close(got["dist_corr"], float(ref["dist_corr"]), 1e-4, 1e-6)
    n_live = float(np.maximum((np.asarray(jb.n_sig) > 0).sum(), 1))
    for k in ("cov50_all", "cov90_all"):
        assert np.abs(got[k] - np.asarray(ref[k])).max() <= 1.0 / n_live + 1e-6
    for k in ("dist_cov50", "dist_cov90"):
        assert abs(got[k] - float(ref[k])) <= 1.0 / n_live + 1e-6


def test_gate_metrics_match_jax(setup):
    jcfg, params, jb, tb, model = setup
    key = jax.random.PRNGKey(6)
    ref = jgates.make_calibration_metrics(jcfg, n_events=N_EVENTS,
                                          n_post=N_POST)(params, jb, key)
    z = np.asarray(jax.random.normal(key, (N_EVENTS, N_POST,
                                           jcfg.npe.n_params)))
    got = tgates.make_calibration_metrics(
        port_config(jcfg), n_events=N_EVENTS, n_post=N_POST)(
        model, tb, z=torch.from_numpy(z))
    live = np.asarray(ref["live_mask"])
    n_live = max(live.sum(), 1.0)
    np.testing.assert_array_equal(got["live_mask"].numpy(), live)
    assert _close(float(got["base_conc"]), float(ref["base_conc"]), 1e-4)
    assert abs(float(got["spurious_railing"])
               - float(ref["spurious_railing"])) <= 1.0 / (n_live * N_POST)
    for k in ("cov90_mean", "cov90_highsnr_mean"):
        assert abs(float(got[k]) - float(ref[k])) <= 1.0 / n_live + 1e-6, k
    d = np.abs(got["sbc_ranks"].numpy() - np.asarray(ref["sbc_ranks"]))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sbc_pass_frac_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_post = 64
    # uniform ranks, and a parameter whose ranks pile at the edge
    ranks = rng.integers(0, n_post + 1, (200, 11))
    ranks[:, 3] = rng.integers(0, 4, 200)
    live = (rng.uniform(size=200) > 0.1).astype(np.float32)
    if seed == 2:
        live[:] = 0.0
        live[:5] = 1.0                  # too few live events: 1.0
    got = tgates.sbc_pass_frac(ranks, live, n_post)
    ref = jgates.sbc_pass_frac(ranks, live, n_post)
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12)


GATE_CASES = [
    {"spurious_railing": 0.01, "base_conc": 1.0, "cov90_mean": 0.9,
     "sbc_pass_frac": 1.0},
    {"spurious_railing": 0.5, "base_conc": 1.0, "cov90_mean": 0.9},
    {"spurious_railing": 0.1, "base_conc": 2.0, "cov90_mean": 0.8,
     "sbc_pass_frac": 9.0 / 11.0},
    {"spurious_railing": 0.0, "base_conc": 0.49, "cov90_mean": 0.95},
    {"spurious_railing": 0.0, "base_conc": 1.0, "cov90_mean": 0.79},
    {"spurious_railing": 0.0, "base_conc": 1.0, "cov90_mean": 0.9,
     "sbc_pass_frac": 0.5},
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_gate_passes_matches_jax(case):
    m = GATE_CASES[case]
    assert tgates.CalibrationGate().passes(m) == \
        jgates.CalibrationGate().passes(m)


@pytest.mark.parametrize("passing", [(), (2,), (2, 3), (1, 2, 3)])
def test_select_best_matches_jax(passing):
    hist = [{"epoch": e, "select_nll": v, "gate_passed": e in passing}
            for e, v in ((1, 1.0), (2, 2.0), (3, 1.5))]
    assert tgates.select_best(hist) == jgates.select_best(hist)


@pytest.mark.parametrize("n,c", [(300, 40), (64, 256)])
def test_fit_context_stats_matches_sklearn(n, c):
    """The port's numpy Ledoit-Wolf against the JAX package's (sklearn's
    LedoitWolf, precision by pinvh), more and fewer contexts than
    features."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, c)) @ rng.standard_normal((c, c)) + 3.0
    got, ref = fit_context_stats(x), jfit_stats(x)
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-12)
    scale = np.abs(ref.precision).max()
    assert np.abs(got.precision - ref.precision).max() <= 1e-9 * scale
    np.testing.assert_allclose(got.val_dists, ref.val_dists, rtol=1e-9)


def test_merge_params_from_an_11d_release_matches_jax():
    """npe_r5_best (11-D) into the 15-D flagship config: the port
    transfers the same count of leaves as JAX's _merge_params (the encoder
    and the rank embedding; the flow's shapes differ), and the merged
    weights load."""
    meta = json.loads((ROOT / "model_release" / "npe_r7_best" /
                       "meta.json").read_text())
    jcfg = jcfg_from_dict(meta["config"])
    fresh = jax.eval_shape(lambda k: jinit_state(k, jcfg).params,
                           jax.random.PRNGKey(0))
    loaded = msgpack_restore((ROOT / "model_release" / "npe_r5_best" /
                              "params.msgpack").read_bytes())
    _, j_kept, j_total = jmerge(fresh, loaded)

    cfg = load_config(ROOT / "model_release" / "npe_r7_best" / "meta.json")
    model = TNPE(cfg.npe)
    merged, kept, total = _merge_params(
        model.state_dict(), load_release(ROOT / "model_release" /
                                         "npe_r5_best")[0])
    assert (kept, total) == (j_kept, j_total)
    assert 0 < kept < total
    model.load_state_dict(merged, strict=True)
