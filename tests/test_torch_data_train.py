"""Training on real noise, on the CPU: batch_nll and its gradients on a
batch simulated with a noise bank against the JAX package's (the coherent
encoder's sensitivity branch, noise_fc1, takes a gradient only from such a
batch); fit(bank=) with the JAX package's history keys and selection;
tools/train_npe.py --noise-bank and its rules; tools/bench_train.py with
its default bank and with --no-bank.

Tolerances (tests/test_torch_train_step.py's, float32): the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest entry after
an allowance of 1e-6 of the largest entry of any leaf.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posteriflow_tpu.models.npe import LeanNPE as JNPE
from posteriflow_tpu.physics.simulator import EventBatch as JBatch
from posteriflow_tpu.train.trainer import batch_nll as jbatch_nll
from posteriflow_torch.data.noise_bank import (load_noise_bank,
                                               make_synthetic_bank,
                                               save_bank_segment)
from posteriflow_torch.models.npe import NPEConfig
from posteriflow_torch.physics.constants import N_RFFT, N_SAMPLES
from posteriflow_torch.physics.simulator import SimConfig, simulate_batch
from posteriflow_torch.prior import PriorConfig
from posteriflow_torch.tools import bench_train, train_npe
from posteriflow_torch.train.checkpoints import _cfg_to_dict
from posteriflow_torch.train.loop import fit
from posteriflow_torch.train.trainer import (TrainConfig, backward, batch_nll,
                                             init_state, make_train_step)
from torch_sim_helpers import one_torch_thread
from torch_train_helpers import (CONFIGS, jax_params, port_config,
                                 port_model, to_state_dict, with_dtype)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP_META = ROOT / "model_release" / "npe_r7_best" / "meta.json"
TINY = TrainConfig(
    npe=NPEConfig(context_dim=32, rank_dim=8, flow_layers=2, flow_hidden=32,
                  flow_bins=4, encoder_type="conv", d_model=32,
                  enc_layers=1, enc_heads=4, psd_cond=True),
    sim=SimConfig(prior=PriorConfig(max_signals=2), det_dropout=0.1),
    batch_size=2, warmup_steps=1, total_steps=50, lr=1e-3)


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _small_bank(seed=0):
    return make_synthetic_bank(torch.Generator().manual_seed(seed),
                               n_segments=2, segment_len=N_SAMPLES + 2048,
                               device="cpu")


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(0)
    for det in ("H1", "L1", "V1"):
        for gps in (1262000000, 1262004096):
            save_bank_segment(d, det, gps,
                              rng.standard_normal(N_SAMPLES + 2048),
                              4e-24 * np.exp(rng.normal(0, 0.3, N_RFFT)))
    return d


def test_batch_nll_on_a_bank_batch_matches_jax():
    jcfg = with_dtype(CONFIGS["coherent"], "float32")
    tcfg = port_config(jcfg)
    sim = dataclasses.replace(tcfg.sim, real_noise_prob=1.0)
    tb = simulate_batch(2, sim, device="cpu", bank=_small_bank(),
                        generator=torch.Generator().manual_seed(3))
    assert float(tb.asd_bands.abs().max()) > 1e-3
    jb = JBatch(*[jnp.asarray(t.numpy()) for t in tb])
    # off the initial point, where the zero output projections make the
    # loss blind to the context (and every encoder gradient zero)
    leaves, tree = jax.tree_util.tree_flatten(jax_params(jcfg))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_unflatten(tree, [
        x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        for x in leaves])
    model = JNPE(jcfg.npe)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jbatch_nll(model, p, b)))(params, jb)
    jl, jg = float(jl), to_state_dict(jg)
    tmodel = port_model(jcfg, params)
    loss = batch_nll(tmodel, tb)
    backward(loss)
    tg = {n: p.grad for n, p in tmodel.named_parameters()}
    assert abs(float(loss.detach()) - jl) <= 1e-5 * abs(jl)
    scale = max(float(g.abs().max()) for g in jg.values())
    for name, g in jg.items():
        d = float((tg[name] - g).abs().max())
        assert d <= 1e-4 * float(g.abs().max()) + 1e-6 * scale, (name, d)
    assert float(tg["encoder.noise_fc1.weight"].abs().max()) > 0
    # the same events with design bands: the branch takes no gradient
    tmodel.zero_grad()
    backward(batch_nll(tmodel, tb._replace(
        asd_bands=torch.zeros_like(tb.asd_bands))))
    assert float(tmodel.encoder.noise_fc1.weight.grad.abs().max()) == 0.0


def test_train_step_with_a_bank_draws_after_the_gaussian_stream():
    """make_train_step(bank=) trains on real noise; at real_noise_prob 0
    the bank changes nothing."""
    bank = _small_bank()
    for prob in (0.0, 0.5):
        cfg = dataclasses.replace(TINY, sim=dataclasses.replace(
            TINY.sim, real_noise_prob=prob))
        out = []
        for b in (None, bank):
            state = init_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
            with torch.no_grad():        # a context the loss can see
                for p in state.model.parameters():
                    p.add_(0.05 * torch.randn(
                        p.shape, generator=torch.Generator().manual_seed(5)))
            m = make_train_step(cfg, b)(state,
                                        torch.Generator().manual_seed(1))
            out.append(float(m["nll"]))
        assert np.isfinite(out).all()
        assert (out[0] == out[1]) == (prob == 0.0), (prob, out)


def _jax_record_keys() -> set:
    return set(json.loads(FLAGSHIP_META.read_text())["metrics"]) - {
        "init_from"}


def test_fit_with_a_bank_writes_jax_history_keys(tmp_path):
    cfg = dataclasses.replace(TINY, sim=dataclasses.replace(
        TINY.sim, real_noise_prob=0.5))
    _, hist = fit(cfg, tmp_path, epochs=1, steps_per_epoch=2,
                  n_val_events=8, seed=2, device="cpu", bank=_small_bank())
    saved = json.loads((tmp_path / "history.json").read_text())
    assert set(saved[-1]) == _jax_record_keys()
    rec = saved[-1]
    assert rec["select_nll"] == pytest.approx(
        0.5 * (rec["val_nll"] + rec["real_val_nll"]), rel=1e-12)
    assert rec["real_val_nll"] != rec["val_nll"]
    assert (tmp_path / "ckpt" / "best" / "state.pt").exists()


def test_train_npe_tool_with_a_noise_bank(tmp_path, bank_dir):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_cfg_to_dict(TINY)))
    hist = train_npe.main(["--config", str(cfg), "--outdir",
                           str(tmp_path / "run"), "--epochs", "1",
                           "--steps-per-epoch", "2", "--noise-bank",
                           str(bank_dir), "--device", "cpu"])
    assert "real_val_nll" in hist[0] and hist[0]["lr_step"] == 2
    meta = json.loads((tmp_path / "run" / "ckpt" / "best" / "meta.json")
                      .read_text())
    # a bank with real_noise_prob 0 in the config trains at 0.5
    assert meta["config"]["sim"]["real_noise_prob"] == 0.5
    with pytest.raises(SystemExit) as e:
        train_npe.main(["--config", str(cfg), "--outdir",
                        str(tmp_path / "no"), "--real-noise-prob", "0.3",
                        "--device", "cpu"])
    assert e.value.code == 2
    assert not (tmp_path / "no").exists()


def test_bench_train_with_and_without_its_bank(tmp_path, capsys):
    """The flagship-style config (real_noise_prob > 0) benches on a
    synthetic bank of 8 segments unless --no-bank."""
    cfg = dataclasses.replace(TINY, sim=dataclasses.replace(
        TINY.sim, real_noise_prob=0.5))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_cfg_to_dict(cfg)))
    reports = []
    for extra in ([], ["--no-bank"]):
        reports.append(bench_train.main(["--config", str(path), "--steps",
                                         "1", "--warmup", "1", "--device",
                                         "cpu", *extra]))
    with_bank, without = reports
    assert with_bank["real_noise_prob"] == 0.5
    assert with_bank["bank_segments"] == bench_train.BANK_SEGMENTS
    assert without["real_noise_prob"] == 0.0
    assert without["bank_segments"] is None
    for r in reports:
        assert np.isfinite(r["final_nll"]) and r["steps_per_sec"] > 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["bank_segments"] is None


def test_load_noise_bank_feeds_the_trainer(bank_dir):
    bank = load_noise_bank(bank_dir, psd_bands=16, device="cpu")
    cfg = dataclasses.replace(TINY, sim=dataclasses.replace(
        TINY.sim, real_noise_prob=1.0))
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = make_train_step(cfg, bank)(state, torch.Generator().manual_seed(2))
    assert np.isfinite(float(m["nll"])) and state.step == 1
