"""tools/calibrate_priority_net.py and tools/priority_fusion_bound.py
against the JAX package.

The calibrator fit in each of its three modes equals JAX's
core/calibrator.OutputCalibrator on the same (score, target) pairs within
1e-5 (gain and bias; both fit in float64 numpy). The fusion bound's three
channels and their pairwise accuracies equal scripts/priority_fusion_bound.py
exactly when both are given the same scenario batch.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from posteriflow_torch.tools import calibrate_priority_net as cal_tool
from posteriflow_torch.tools import priority_fusion_bound as bound
from posteriflow_torch.train.train_priority import (PriorityTrainConfig,
                                                    load_priority_net,
                                                    make_priority_batch)
from torch_sim_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
V7 = ROOT / "model_release" / "priority_v7"
CAL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


@pytest.fixture(scope="module")
def scores():
    net = load_priority_net(V7, device="cpu")
    return cal_tool.collect_scores(net, n_batches=1, seed=99, device="cpu",
                                   batch=8)


@pytest.mark.parametrize("mode", cal_tool.MODES)
def test_calibrator_fit_equals_jax(scores, mode):
    from posteriflow_tpu.core.calibrator import OutputCalibrator
    s, t = scores
    assert len(s) == len(t) >= 8
    got = cal_tool.calibrate(s, t, mode)
    ref = OutputCalibrator().fit(s, t, mode=mode)
    assert got["mode"] == ref.mode == mode
    assert abs(got["gain"] - float(ref.gain)) <= CAL_TOL
    assert abs(got["bias"] - float(ref.bias)) <= CAL_TOL
    assert abs(got["mae_after"]
               - float(np.abs(ref(s) - t).mean())) <= CAL_TOL


def test_calibrate_tool_writes_the_jax_report(tmp_path):
    out = tmp_path / "cal.json"
    rep = cal_tool.main(["--params", str(V7 / "priority_params.msgpack"),
                         "--n-batches", "1", "--mode", "minmax",
                         "--device", "cpu", "--out", str(out)])
    assert set(rep) == {"gain", "bias", "mode", "mae_before", "mae_after",
                        "n_pairs"}
    assert json.loads(out.read_text()) == rep and rep["mode"] == "minmax"


def test_fusion_bound_equals_the_jax_script(tmp_path, monkeypatch):
    """One port scenario batch fed to both scripts' channel code."""
    import jax
    import jax.numpy as jnp

    import posteriflow_tpu.train.train_priority as jtp
    sys.path.insert(0, str(ROOT / "scripts"))
    import priority_fusion_bound as j_bound
    cfg = PriorityTrainConfig()
    batch = [x.numpy() for x in make_priority_batch(
        cfg, torch.Generator().manual_seed(3), "cpu")]
    monkeypatch.setattr(jtp, "make_priority_batch", lambda key, c: tuple(
        jnp.asarray(x) for x in batch))
    import posteriflow_torch.train.train_priority as ttp
    monkeypatch.setattr(ttp, "make_priority_batch", lambda c, g, d: tuple(
        torch.from_numpy(x) for x in batch))
    # the JAX script's compilation cache would be written outside the
    # checkout: its cache settings are dropped
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache"
                        in k else update(k, v))
    ref = j_bound.main(["--n-batches", "1", "--cpu", "--out",
                        str(tmp_path / "jax.json")])
    got = bound.main(["--n-batches", "1", "--device", "cpu", "--out",
                      str(tmp_path / "port.json")])
    assert got["pairwise_acc_by_target_sep"] == \
        ref["pairwise_acc_by_target_sep"]
    assert got["n_pairs_close"] == ref["n_pairs_close"]
    committed = json.loads((ROOT / "reports" / "priority_fusion_bound.json")
                           .read_text())
    assert set(committed) <= set(got)
