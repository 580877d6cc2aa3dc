"""The rest of training in the port against the JAX package: fit's
val_batch_fn and on_epoch_end hooks, trainer.make_optimizer's schedule
(optax), LeanNPE.sample / LeanNPE.nll, utils/noise_marginalization.py and
tools/train_npe.py's YAML config, model overrides, --profile-dir and
--mesh.

Tolerances: the learning rate within 1e-7 of optax's (absolute, at lr
1e-3); group_mean_loss within 1e-6 of JAX's; LeanNPE.nll within 1e-5 nats
of JAX's and sample within 1e-4 of the largest |θ| on the same base draws
(float32 flows); the hooks and the sample/nll entries exact.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posteriflow_torch.physics.simulator import simulate_batch
from posteriflow_torch.train.loop import _VAL, fit
from posteriflow_torch.train.trainer import (batch_nll, make_optimizer,
                                             step_seed)
from posteriflow_torch.utils.config import load_config, save_config
from posteriflow_torch.utils.noise_marginalization import (
    group_mean_loss, repeat_params_k_noise)
from torch_sim_helpers import one_torch_thread  # noqa: F401
from torch_train_helpers import (CONFIGS, batches, jax_params, port_config,
                                 port_model)

TINY = port_config(dataclasses.replace(CONFIGS["conv"], batch_size=2))
LR_TOL, GROUP_TOL, NLL_TOL, SAMPLE_REL = 1e-7, 1e-6, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def test_fit_hooks_fire_once_an_epoch_with_the_record(tmp_path):
    seen, recs = [], []

    def val_batch_fn(gen):
        seen.append(gen.initial_seed())
        seen.append(simulate_batch(6, TINY.sim, device="cpu",
                                   generator=gen))
        return seen[-1]

    def on_epoch_end(rec):
        hist = json.loads((tmp_path / "run" / "history.json").read_text())
        assert hist[-1] == json.loads(json.dumps(rec))  # written before
        recs.append(rec)

    state, history = fit(TINY, tmp_path / "run", epochs=2,
                         steps_per_epoch=1, n_val_events=6, seed=4,
                         device="cpu", val_batch_fn=val_batch_fn,
                         on_epoch_end=on_epoch_end)
    assert seen[0] == step_seed(4, 0, _VAL)   # the default batch's seed
    assert [r["epoch"] for r in recs] == [1, 2] and recs == history
    with torch.no_grad():
        apart = float(batch_nll(state.model, seen[1]))
    assert history[-1]["val_nll"] == apart


@pytest.mark.parametrize("count", [0, 1, 2, 5, 9, 10, 14])
def test_make_optimizer_lr_equals_optax(count):
    """warmup 2, total 10 (the conv test config): the warmup, the cosine
    and the floor past the end."""
    cfg = port_config(CONFIGS["conv"])
    opt = make_optimizer(cfg, port_model(CONFIGS["conv"],
                                         jax_params(CONFIGS["conv"])))
    opt.count = count
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.lr, warmup_steps=cfg.warmup_steps,
        decay_steps=cfg.total_steps, end_value=0.01 * cfg.lr)
    assert abs(opt.lr() - float(sched(count))) <= LR_TOL


@pytest.mark.parametrize("case", ["random", "empty_groups", "one_group"])
def test_group_mean_loss_equals_jax(case):
    from posteriflow_tpu.utils.noise_marginalization import \
        group_mean_loss as j_group
    rng = np.random.default_rng(len(case))
    n, groups = 40, 7
    losses = rng.normal(3.0, 2.0, n).astype(np.float32)
    ids = {"random": rng.integers(0, groups, n),
           "empty_groups": rng.choice([0, 3, 6], n),
           "one_group": np.full(n, 2)}[case].astype(np.int64)
    got = float(group_mean_loss(torch.from_numpy(losses),
                                torch.from_numpy(ids), groups))
    ref = float(j_group(jnp.asarray(losses), jnp.asarray(ids), groups))
    assert abs(got - ref) <= GROUP_TOL


def test_repeat_params_k_noise_layout_equals_jax():
    from posteriflow_tpu.utils.noise_marginalization import \
        repeat_params_k_noise as j_repeat
    params = np.arange(12, dtype=np.float32).reshape(4, 3)
    rep, gids, seeds = repeat_params_k_noise(5, torch.from_numpy(params), 3)
    j_rep, j_gids, j_keys = j_repeat(jax.random.PRNGKey(5),
                                     jnp.asarray(params), 3)
    assert np.array_equal(rep.numpy(), np.asarray(j_rep))
    assert np.array_equal(gids.numpy(), np.asarray(j_gids))
    assert len(seeds) == len(j_keys) == 12 and len(set(seeds)) == 12
    assert np.array_equal(seeds, repeat_params_k_noise(
        5, torch.from_numpy(params), 3)[2])


def test_sample_and_nll_are_encode_then_from_context():
    jcfg = CONFIGS["conv"]
    params = jax_params(jcfg)
    model = port_model(jcfg, params).eval()
    jb, tb = batches(jcfg, 1, 3, seed=2)[0]
    ranks = torch.tensor([0, 1, 0])
    theta = tb.params[:, 0]
    with torch.no_grad():
        ctx = model.encode(tb.strain, tb.asd_bands)
        nll = model.nll(tb.strain, theta, ranks, tb.asd_bands)
        assert torch.equal(nll, model.nll_from_context(ctx, theta, ranks))
        key = jax.random.PRNGKey(7)
        z = torch.from_numpy(np.array(jax.random.normal(
            key, (3, 16, jcfg.npe.n_params))))
        draws = model.sample(tb.strain, rank=1, n_samples=16,
                             asd_bands=tb.asd_bands, z=z)
        ref = model.sample_from_context(ctx, torch.ones(3, dtype=torch.long),
                                        16, z=z)[0]
        assert torch.equal(draws, ref)

    from posteriflow_tpu.models.npe import LeanNPE as JNPE
    jm = JNPE(jcfg.npe)
    j_nll = jax.jit(lambda p, s, t, r: jm.apply(p, s, t, r,
                                                method=JNPE.nll))(
        params, jb.strain, jnp.asarray(theta.numpy()),
        jnp.asarray(ranks.numpy()))
    assert np.abs(nll.numpy() - np.asarray(j_nll)).max() <= NLL_TOL
    j_draws = jax.jit(lambda p, k, s: jm.apply(
        p, k, s, 1, 16, method=JNPE.sample))(params, key, jb.strain)
    j_draws = np.asarray(j_draws)
    assert np.abs(draws.numpy() - j_draws).max() <= \
        SAMPLE_REL * np.abs(j_draws).max()


def test_train_npe_from_yaml_with_overrides_and_a_trace(tmp_path):
    """A YAML config, the model and simulator overrides of the JAX script,
    and a torch.profiler trace of the first epoch; --mesh (ROADMAP §1
    item 5) trains the same config data-parallel."""
    from posteriflow_torch.tools import train_npe
    cfg = dataclasses.replace(TINY, warmup_steps=1)
    cfg_path = tmp_path / "tiny.yaml"
    save_config(cfg, cfg_path)
    hist = train_npe.main(["--config", str(cfg_path), "--outdir",
                           str(tmp_path / "run"), "--epochs", "1",
                           "--steps-per-epoch", "2", "--device", "cpu",
                           "--psd-cond", "--det-dropout", "0.25",
                           "--premerger", "--profile-dir",
                           str(tmp_path / "trace")])
    assert hist[0]["lr_step"] == 2
    saved = load_config(tmp_path / "run" / "ckpt" / "best")
    assert saved.npe.psd_cond and saved.npe.premerger
    assert saved.sim.det_dropout == 0.25
    assert saved.npe.encoder_type == cfg.npe.encoder_type
    assert dataclasses.replace(
        saved, npe=cfg.npe, sim=cfg.sim, total_steps=cfg.total_steps) == cfg
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100
    # --mesh without a launcher: one gloo rank on the CPU, spawned by the
    # tool, whose rank 0 writes the run
    hist_m = train_npe.main(["--config", str(cfg_path), "--outdir",
                             str(tmp_path / "m"), "--epochs", "1",
                             "--steps-per-epoch", "2", "--mesh",
                             "--device", "cpu"])
    assert [h["epoch"] for h in hist_m] == [1]
    assert hist_m[0]["lr_step"] == 2
    assert (Path(tmp_path / "m") / "ckpt" / "best" / "state.pt").exists()


@pytest.mark.parametrize("device, activity", [("cpu", "CPU"),
                                              ("cuda", "CUDA")])
def test_torch_trace_records_the_run_devices_activity(device, activity,
                                                      monkeypatch, tmp_path):
    """The trace records the card's activity for a run on the card, with
    the host's pf.* spans and no host operator (UserScopeProfile), and
    the host's operators for a run on the CPU, whatever the machine
    has."""
    from torch import profiler

    from posteriflow_torch.utils import logging as plog
    seen = []

    class Recorder:
        def __init__(self, kind, activities):
            seen.append((kind, sorted(a.name for a in activities)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            Path(path).write_text("{}")

    monkeypatch.setattr(profiler, "profile",
                        lambda activities: Recorder("all", activities))
    monkeypatch.setattr(plog, "UserScopeProfile",
                        lambda activities: Recorder("user", activities))
    with plog.torch_trace(str(tmp_path), device) as trace:
        trace.stop()
    assert seen == ([("all", [activity])] if activity == "CPU"
                    else [("user", ["CPU", activity])])
    assert (tmp_path / "trace.json").exists()
