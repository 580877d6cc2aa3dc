"""The port's training loop and checkpoints on the CPU (no JAX): save and
restore, fine_tune_restore, `fit` for 2 epochs x 2 steps with history.json
in the JAX package's record keys (those of the flagship release's own
meta.json, which JAX's fit wrote), resume_from, a training checkpoint
served through InferenceEngine.from_checkpoint, load_config, and
tools/train_npe.py at the tiny size.

This file imports neither JAX nor the JAX package, so that on a machine
without them it runs with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_train_loop.py
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from posteriflow_torch.inference.pipeline import InferenceEngine
from posteriflow_torch.models.npe import NPEConfig
from posteriflow_torch.physics.simulator import SimConfig
from posteriflow_torch.prior import PriorConfig
from posteriflow_torch.tools import train_npe
from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                 _cfg_to_dict)
from posteriflow_torch.train.loop import fit
from posteriflow_torch.train.trainer import TrainConfig, init_state
from posteriflow_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP_META = ROOT / "model_release" / "npe_r7_best" / "meta.json"
TINY = TrainConfig(
    npe=NPEConfig(context_dim=32, rank_dim=8, flow_layers=2, flow_hidden=32,
                  flow_bins=4, encoder_type="conv", d_model=32,
                  enc_layers=1, enc_heads=4),
    sim=SimConfig(prior=PriorConfig(max_signals=2), det_dropout=0.1),
    batch_size=4, warmup_steps=1, total_steps=50, lr=1e-3)


def _jax_record_keys(with_init_from: bool) -> set:
    """The keys of a history record that JAX's fit wrote (the flagship's
    meta.json), without the noise bank's real_* keys."""
    keys = {k for k in json.loads(FLAGSHIP_META.read_text())["metrics"]
            if not k.startswith("real_")}
    return keys if with_init_from else keys - {"init_from"}


def test_checkpoint_roundtrip(tmp_path):
    """Weights, the optimizer's moments and step, the whole config and the
    metrics come back."""
    state = init_state(TINY, torch.Generator().manual_seed(0), device="cpu")
    for p in state.model.parameters():
        p.grad = torch.randn_like(p)
    state.opt.step()
    state.opt.step()
    cm = CheckpointManager(tmp_path)
    cm.save("best", state, TINY, {"val_nll": 1.5, "cov": [0.5, 0.25]},
            epoch=3)
    got, cfg, meta = cm.restore("best", device="cpu")
    assert cfg == TINY
    assert meta["epoch"] == 3 and meta["metrics"]["val_nll"] == 1.5
    assert meta["config"] == json.loads(json.dumps(_cfg_to_dict(TINY)))
    assert got.step == 2
    for (n, a), b in zip(state.model.state_dict().items(),
                         got.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt.mu + state.opt.nu, got.opt.mu + got.opt.nu):
        assert torch.equal(a, b)


def test_fine_tune_restore_gives_a_fresh_optimizer(tmp_path):
    state = init_state(TINY, torch.Generator().manual_seed(1), device="cpu")
    for p in state.model.parameters():
        p.grad = torch.randn_like(p)
    state.opt.step()
    cm = CheckpointManager(tmp_path)
    cm.save("best", state, TINY, epoch=9)
    new_cfg = dataclasses.replace(TINY, lr=5e-4)
    ft, meta = cm.fine_tune_restore("best", new_cfg, device="cpu")
    assert meta["epoch"] == 9 and ft.step == 0 and ft.opt.cfg == new_cfg
    assert all(not m.any() for m in ft.opt.mu + ft.opt.nu)
    for a, b in zip(state.model.parameters(), ft.model.parameters()):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("fit")
    _, hist = fit(TINY, out, epochs=2, steps_per_epoch=2, n_val_events=8,
                  seed=3, ckpt_every=2, device="cpu")
    return out, hist


def test_fit_writes_jax_history_keys_and_checkpoints(run):
    out, hist = run
    saved = json.loads((out / "history.json").read_text())
    assert [h["epoch"] for h in saved] == [1, 2]
    assert set(saved[-1]) == _jax_record_keys(with_init_from=False)
    assert [h["lr_step"] for h in saved] == [2, 4]
    for h in saved:
        for k in ("train_nll", "val_nll", "grad_norm", "spurious_railing",
                  "base_conc", "cov90_mean", "sbc_pass_frac"):
            assert isinstance(h[k], float) and h[k] == h[k], k
        assert isinstance(h["gate_passed"], bool)
        assert len(h["cov90_all"]) == TINY.npe.n_params
    for name in ("last", "best", "epoch_0002"):
        assert (out / "ckpt" / name / "state.pt").exists(), name
        assert (out / "ckpt" / name / "meta.json").exists(), name


def test_resume_continues_epochs_and_step(run, tmp_path):
    out, _ = run
    _, hist = fit(TINY, out, epochs=1, steps_per_epoch=2, n_val_events=8,
                  seed=3, resume_from=str(out / "ckpt" / "last"),
                  device="cpu")
    assert [h["epoch"] for h in hist] == [1, 2, 3]
    assert hist[-1]["lr_step"] == 6
    assert hist[-1]["resume_from"] == str(out / "ckpt" / "last")


def test_from_checkpoint_serves_a_training_checkpoint(run):
    out, _ = run
    eng = InferenceEngine.from_checkpoint(out / "ckpt", "best", device="cpu")
    ctx = eng.encode(torch.randn(1, 3, 16384), torch.zeros(1, 3, 16))
    theta, log_q, _ = eng.sample_posterior(
        ctx, 0, 64, generator=torch.Generator().manual_seed(0))
    assert theta.shape == (1, 64, TINY.npe.n_params)
    assert bool(torch.isfinite(theta).all() and torch.isfinite(log_q).all())


def test_from_checkpoint_of_a_missing_path_raises_and_writes_nothing(
        tmp_path):
    missing = tmp_path / "no" / "such" / "ckpt"
    with pytest.raises(FileNotFoundError, match="state.pt"):
        InferenceEngine.from_checkpoint(missing, "best", device="cpu")
    assert not (tmp_path / "no").exists()


def test_load_config(tmp_path):
    """A release's meta.json and its directory give its TrainConfig; a
    JSON or YAML of overrides merges over the defaults; an unknown key and
    YAML outside the reader's subset raise."""
    flagship = load_config(FLAGSHIP_META)
    assert flagship == load_config(FLAGSHIP_META.parent)
    assert flagship.batch_size == 128 and flagship.npe.n_params == 15
    assert flagship.sim.prior.precessing
    p = tmp_path / "over.json"
    p.write_text(json.dumps({"lr": 1e-4, "npe": {"flow_bins": 8}}))
    over = load_config(p)
    assert over.lr == 1e-4 and over.npe.flow_bins == 8
    assert over.npe.context_dim == TrainConfig().npe.context_dim
    p.write_text(json.dumps({"npe": {"flow_binz": 8}}))
    with pytest.raises(KeyError, match="flow_binz"):
        load_config(p)
    y = tmp_path / "cfg.yaml"
    y.write_text("lr: 1.0e-4  # a float: it has a dot\nnpe:\n  flow_bins: 8\n")
    assert load_config(y) == over
    y.write_text("npe: &a\n  flow_bins: 8\n")
    with pytest.raises(ValueError, match="cfg.yaml:1"):
        load_config(y)


def test_train_npe_tool_on_the_cpu(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_cfg_to_dict(TINY)))
    hist = train_npe.main(["--config", str(cfg), "--outdir",
                           str(tmp_path / "run"), "--epochs", "1",
                           "--steps-per-epoch", "2", "--batch", "2",
                           "--grad-clip-mode", "agc", "--device", "cpu"])
    assert [h["epoch"] for h in hist] == [1] and hist[0]["lr_step"] == 2
    meta = json.loads((tmp_path / "run" / "ckpt" / "best" / "meta.json")
                      .read_text())
    assert meta["config"]["batch_size"] == 2
    assert meta["config"]["grad_clip_mode"] == "agc"
    assert meta["config"]["total_steps"] == 2 * 1
