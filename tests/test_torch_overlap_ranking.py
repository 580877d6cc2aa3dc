"""Overlap ranking of the port against the JAX package on the CPU:
extract_segments, rank_overlapping on the same per-rank posteriors (11-D
and 15-D medians) with the released priority_v7 and with the loudness
fallback, tools/infer.py --n-signals on an injection, and the overlap
benchmark and the evaluation battery at a few events.

Tolerances: segments bit-equal (the same numpy code); the net's scores
within 1e-4 of the largest |score| plus 1e-5 (as the released nets are
held in tests/test_torch_priority_net.py), the fallback's within 1e-6
relative, and the orders equal (the cases' scores are far apart)."""

import json

import numpy as np
import pytest
import torch
from torch_overlap_helpers import (  # noqa: F401
    jax_release, one_torch_thread, port_release)

from posteriflow_tpu.inference import ranking as jrank
from posteriflow_tpu.inference.result import PosteriorResult as JResult
from posteriflow_torch import PARAM_NAMES_PRECESSING
from posteriflow_torch.inference import ranking as trank
from posteriflow_torch.inference.preprocessing import prepare_simulated
from posteriflow_torch.inference.result import PosteriorResult
from posteriflow_torch.tools import infer as cli

# three signals, loudness-ranked (m1, m2, d, ra, dec, theta_jn, psi,
# phase, t_c, a1, a2, then the precession angles)
SIGNALS = np.array([
    [36.0, 29.0, 400.0, 1.0, -0.5, 0.5, 0.3, 1.0, 0.2, 0.3, 0.2,
     1.0, 2.0, 0.5, 1.0],
    [20.0, 15.0, 700.0, 2.5, 0.4, 1.2, 1.1, 2.0, -0.9, 0.5, 0.1,
     0.4, 1.5, 3.0, 2.0],
    [12.0, 9.0, 900.0, 4.0, 1.0, 2.0, 2.5, 4.0, 1.3, 0.1, 0.6,
     2.2, 0.7, 1.0, 5.0]], np.float32)


def test_extract_segments_bit_equal():
    rng = np.random.default_rng(0)
    strain = rng.standard_normal((3, 16384)).astype(np.float32)
    t_offs = np.array([0.0, -1.99, 1.99, 0.3337, -0.25], np.float32)
    np.testing.assert_array_equal(trank.extract_segments(strain, t_offs),
                                  jrank.extract_segments(strain, t_offs))


def _results(p: int, seed: int):
    """(strain, port results, JAX results) of a noiseless 3-signal
    injection with Gaussian posterior clouds around each truth."""
    prep = prepare_simulated(SIGNALS[:, :p], seed=seed, device="cpu",
                             add_noise=False)
    rng = np.random.default_rng(seed)
    t_res, j_res = [], []
    names = PARAM_NAMES_PRECESSING[:p]
    for r, truth in enumerate(prep.truth):
        s = (truth * (1.0 + 0.01 * rng.standard_normal((200, p)))).astype(
            np.float32)
        t_res.append(PosteriorResult(samples=s, rank=r, param_names=names))
        j_res.append(JResult(samples=s, rank=r, param_names=names))
    return prep.strain, t_res, j_res


@pytest.mark.parametrize("p", [11, 15])
def test_rank_overlapping_matches_jax(p):
    strain, t_res, j_res = _results(p, seed=p)
    jnet, jp = jax_release("priority_v7")
    order, scores = trank.rank_overlapping(
        t_res, strain, priority_model=port_release("priority_v7"),
        device="cpu")
    j_order, j_scores = jrank.rank_overlapping(
        j_res, strain, priority_params=jp, priority_model=jnet)
    assert order == j_order
    tol = 1e-4 * np.abs(j_scores).max() + 1e-5
    assert np.abs(np.asarray(scores) - j_scores).max() <= tol
    fb = trank.rank_overlapping(t_res, strain, use_default_net=False,
                                device="cpu")
    j_fb = jrank.rank_overlapping(j_res, strain, use_default_net=False)
    assert fb[0] == j_fb[0] == [0, 1, 2]
    np.testing.assert_allclose(fb[1], j_fb[1], rtol=1e-6)


def test_default_net_is_the_v7_release():
    net = trank._default_priority_net("cpu")
    ref = port_release("priority_v7")
    assert net.use_dt and net.residual_snr
    for a, b in zip(net.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A port checkpoint of the JAX tests' TINY config (untrained)."""
    from torch_is_helpers import TINY

    from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                     _cfg_to_dict,
                                                     train_cfg_from_dict)
    from posteriflow_torch.train.trainer import init_state
    cfg = train_cfg_from_dict(_cfg_to_dict(TINY))
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    root = tmp_path_factory.mktemp("ckpt")
    CheckpointManager(root).save("best", state, cfg, {"val_nll": 0.0})
    return root


def test_cli_n_signals_writes_ranking(tiny_ckpt, tmp_path, capsys):
    out = tmp_path / "overlap"
    results = cli.main(["--ckpt", str(tiny_ckpt), "--inject", "--n-signals",
                        "2", "--n-samples", "64", "--seed", "4",
                        "--device", "cpu", "--out", str(out)])
    assert [r.rank for r in results] == [0, 1]
    injected = json.loads(capsys.readouterr().out.split(
        "injected params:", 1)[1].splitlines()[0])
    assert len(injected) == 2 and injected[0] != injected[1]
    ranking = json.loads((out / "ranking.json").read_text())
    assert sorted(ranking["order"]) == [0, 1] and len(ranking["scores"]) == 2
    assert all(np.isfinite(ranking["scores"]))
    for r in range(2):
        assert np.load(out / f"rank{r}" / "samples.npy").shape == (64, 11)


def test_overlap_bench_and_priority_eval_run_on_the_cpu(tiny_ckpt):
    """The two tools at a few events: the overlap benchmark's report keys
    and counts, and the evaluation battery's figures in range."""
    from posteriflow_torch.inference.pipeline import InferenceEngine
    from posteriflow_torch.tools import overlap_bench, priority_eval
    engine = InferenceEngine.from_checkpoint(tiny_ckpt, device="cpu")
    rep = overlap_bench.run(engine, n_events=2, n_samples=32, max_signals=2)
    assert set(rep["runtime"]) == {"n1", "n2"}
    assert rep["per_rank"]["n2_rank1"]["n"] == 2
    assert rep["ranking"]["n"] == 2 and 0 <= rep["ranking"]["top1"] <= 1
    assert sum(b["n"] for b in rep["dt_bins"]) == 2
    ev = priority_eval.evaluate(port_release("priority_v7"), n_batches=1,
                                batch=8, device="cpu")
    assert 0 < ev["n_scenarios"] <= 8
    for k in ("top1", "fallback_top1", "oracle_top1"):
        assert 0.0 <= ev[k] <= 1.0, k
    assert sum(ev["pairs_by_target_sep"].values()) > 0
