"""The long-BNS tools of the port on the CPU at a small size:
tools/train_long_bns.py (JAX's optimizer against optax, the run directory
with JAX's history and calibration keys, resume, the scanned epochs, the
refusals) and tools/validate_long_bns.py (JAX's gates and report keys,
chunks rounded up, exit codes, the grid it serves on)."""

import importlib.util
import json
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.tools import train_long_bns as tool
from posteriflow_torch.tools import validate_long_bns as val
from posteriflow_torch.train.checkpoints import load_long_bns
from torch_long_bns_helpers import REPO, V1_RELEASE, V4_RELEASE
from torch_sim_helpers import one_torch_thread  # noqa: F401

TINY = ["--device", "cpu", "--batch", "2", "--d-model", "16",
        "--n-layers", "1", "--n-heads", "2", "--cal-events", "4",
        "--cal-post", "8"]


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test (see torch_sim_helpers.one_torch_thread)."""


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_long_bns", REPO / "scripts" / "validate_long_bns.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("steps", [3, 40, 4000, 50000])
def test_schedule_matches_optax(steps):
    """opt_config's warmup-cosine with the 0.02·lr floor against JAX's
    optax schedule (scripts/train_long_bns.py:175-178) at counts through
    the run and past it: within 1e-6 of the peak lr (optax takes the
    warmup as (0 - lr)·(1 - count/warmup) + lr in float32, which cancels
    to a float32 step of lr)."""
    lr = 3e-4
    cfg = tool.opt_config(lr, steps)
    warmup = min(200, max(1, steps // 10))
    assert (cfg.warmup_steps, cfg.total_steps) == (warmup,
                                                   max(steps, warmup + 1))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), end_value=0.02 * lr)
    model = torch.nn.Linear(2, 2)
    opt = tool.make_optimizer(model, cfg)
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2,
                         steps - 1, steps, steps + 5}):
        opt.count = count
        want = float(sched(count))
        assert abs(opt.lr() - want) <= 1e-6 * lr


def test_updates_match_optax():
    """Three updates of the chain clip_by_global_norm(10) -> adamw(schedule,
    weight_decay=1e-5) on the same parameters and gradients (large enough
    that the clip scales them): within 2e-5 of the distance moved plus two
    float32 steps of the parameter, as tests/test_torch_train_optim.py
    holds the flagship's chain."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    model = torch.nn.Linear(3, 4)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w))
        model.bias.copy_(torch.from_numpy(b))
    cfg = tool.opt_config(1e-2, 20)
    opt = tool.make_optimizer(model, cfg)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 20,
                                               end_value=2e-4)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(sched, weight_decay=1e-5))
    jp = {"w": jnp.asarray(w.T), "b": jnp.asarray(b)}
    state = tx.init(jp)
    for step in range(3):
        gw = (rng.standard_normal((4, 3)) * 8).astype(np.float32)
        gb = (rng.standard_normal(4) * 8).astype(np.float32)
        up, state = tx.update({"w": jnp.asarray(gw.T), "b": jnp.asarray(gb)},
                              state, jp)
        new = optax.apply_updates(jp, up)
        model.weight.grad = torch.from_numpy(gw.copy())
        model.bias.grad = torch.from_numpy(gb.copy())
        opt.step()
        for name, t, old, ref in (("w", model.weight.T, jp["w"], new["w"]),
                                  ("b", model.bias, jp["b"], new["b"])):
            ref, old = np.asarray(ref), np.asarray(old)
            tol = (2e-5 * np.abs(ref - old).max()
                   + 2.4e-7 * np.abs(ref).max() + 1e-12)
            assert np.abs(t.detach().numpy() - ref).max() <= tol, (step, name)
        jp = new
    assert opt.count == 3


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 3-step v4 run at the release's trigger config (its stored grid)
    with a tiny encoder."""
    out = tmp_path_factory.mktemp("lbns") / "run"
    history, cal, run = tool.run_training(
        TINY + ["--outdir", str(out), "--steps", "3", "--eval-every", "2"])
    return out, history, cal, run


def test_train_run_directory(tiny_run):
    """The run directory: JAX's history keys (signal_delta for v4) at
    steps 1 and 2, JAX's calibration keys and config keys, the grid it
    trained on (the stored grid of the release's config), state.pt, and a
    model that load_long_bns serves on that grid."""
    out, history, cal, run = tiny_run
    jax_hist = json.loads((V4_RELEASE / "history.json").read_text())
    jax_cal = json.loads((V4_RELEASE / "calibration.json").read_text())
    assert [h["step"] for h in history] == [1, 2]
    assert list(history[0]) == list(jax_hist[0])
    assert list(cal) == list(jax_cal)
    assert list(cal["config"]) == list(jax_cal["config"])
    assert cal["config"]["tokens"] == jax_cal["config"]["tokens"]
    assert cal["config"]["n_params"] == sum(
        p.numel() for p in run.model.parameters())
    assert json.loads((out / "history.json").read_text()) == history
    assert all(np.isfinite(h["val_nll"]) for h in history)
    stored = tlb.load_stored_grid(jax_cal["config"]["tokens"])
    own = tlb.load_grid(out / "grid.npz")
    for k in tlb.GRID_ARRAYS:
        np.testing.assert_array_equal(own[k], stored[k])
    model, cfg, grid = load_long_bns(out, device="cpu")
    assert cfg == cal["config"] and grid["config"] == stored["config"]
    for a, b in zip(model.state_dict().values(),
                    torch.load(out / "state.pt",
                               weights_only=True)["model"].values()):
        assert torch.equal(a, b)


def test_train_resume_and_scan(tiny_run, tmp_path):
    """--resume continues the history after its last record from the saved
    weights with a fresh optimizer, as JAX's script does (its count is the
    steps run since the resume); --scan N records at each epoch of N
    steps."""
    out, history, _, run = tiny_run
    again = tmp_path / "run"
    shutil.copytree(out, again)
    hist2, _, run2 = tool.run_training(
        TINY + ["--outdir", str(again), "--steps", "4", "--eval-every", "2",
                "--resume"])
    assert [h["step"] for h in hist2] == [1, 2, 4]
    assert run2.opt.count == 2
    hist3, _, _ = tool.run_training(
        TINY + ["--outdir", str(tmp_path / "scan"), "--steps", "4",
                "--scan", "2"])
    assert [h["step"] for h in hist3] == [2, 4]


@pytest.mark.parametrize("flags,item", [
    (["--tokens", "v3"], "item 4"), (["--mesh", "2"], "item 5"),
    (["--prng", "rbg"], "item 3")])
def test_train_refusals(flags, item, tmp_path, capsys):
    """The flags of ROADMAP §1 items 4 and 5 train: --tokens v3 on the
    chirp front end (its "chirp" tokens config recorded), --mesh 2 through
    the sequence-parallel loss on two gloo ranks that the tool spawns
    (rank 0's history, "mesh": 2 recorded, the first step's NLL that of
    the unsharded run). --prng, which the port does not take, raises an
    error that says the port has no PRNG choice and names its item and
    the ROADMAP §3 finding."""
    argv = TINY + ["--outdir", str(tmp_path / "run"), "--steps", "1"]
    if item == "item 3":
        with pytest.raises(SystemExit) as e:
            tool.run_training(argv + flags)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert item in err
        assert "no PRNG choice" in err and "§3 findings" in err
        assert "waits for" not in err
        return
    if item == "item 4":
        argv += ["--duration", "16", "--f-hi", "256"]
    hist, cal, _ = tool.run_training(argv + flags)
    assert (tmp_path / "run" / "params.msgpack").is_file()
    if item == "item 4":
        assert cal["config"]["tokens"]["kind"] == "chirp"
        assert np.isfinite(hist[0]["train_nll"])
        return
    assert cal["config"]["mesh"] == 2
    ref, _, _ = tool.run_training(TINY + ["--outdir", str(tmp_path / "ref"),
                                          "--steps", "1"])
    assert abs(hist[0]["train_nll"] - ref[0]["train_nll"]) <= \
        2e-5 * abs(ref[0]["train_nll"])


def test_validate_tiny_run_fails_gates(tiny_run, tmp_path):
    """The validator on the untrained run: JAX's v4 gates and report keys,
    chunks rounded up (5 events in chunks of 2 -> 6), exit code 1, each
    chunk's scalars and the seconds by part in the record."""
    out = tiny_run[0]
    jax_script = _jax_script()
    assert val.GATES == jax_script.GATES
    assert val.GATES_V4 == jax_script.GATES_V4
    code, report, record = val.run(
        ["--model", str(out), "--device", "cpu", "--n-events", "5",
         "--chunk", "2", "--n-post", "16", "--out", str(tmp_path)])
    assert code == 1 and report["passed"] is False
    jax_report = json.loads((REPO / "reports" / "val_long_bns" /
                             "report.json").read_text())
    assert list(report) == list(jax_report)
    assert list(report["metrics"]) == list(jax_report["metrics"])
    assert list(report["_meta"]) == list(jax_report["_meta"])
    assert [c["gate"] for c in report["checks"]] == list(val.GATES_V4)
    assert report["metrics"]["n_events"] == 6
    assert len(record["chunks"]) == 3
    assert set(record["seconds"]) == {"simulate", "nll", "sampling",
                                      "statistics"}
    assert json.loads((tmp_path / "report.json").read_text()) == report


def test_validate_release_v4_passes(tmp_path):
    """long_bns_v4 as released, served on its stored grid, at 100 events
    (two chunks of 50) × 100 draws on the CPU: exit code 0 and every v4
    gate passing; the report's config hash is JAX's report's."""
    code, report, record = val.run(
        ["--model", str(V4_RELEASE), "--device", "cpu", "--n-events", "100",
         "--n-post", "100", "--out", str(tmp_path)])
    assert code == 0, report["checks"]
    jax_report = json.loads((REPO / "reports" / "val_long_bns" /
                             "report.json").read_text())
    assert report["_meta"]["config_hash"] == \
        jax_report["_meta"]["config_hash"] == "4b30c83f5f60"
    assert report["metrics"]["signal_delta_nll"] > 2.0


def test_validate_v1_and_refusals(tmp_path):
    """long_bns_v1 takes the v1 gates (shuffle ΔNLL, no mc_sharpen); a v4
    run directory whose tokens config has no stored grid and no grid.npz
    raises; a v3 (chirp) run loads, its grid rebuilt from its config."""
    code, report, _ = val.run(
        ["--model", str(V1_RELEASE), "--device", "cpu", "--n-events", "2",
         "--chunk", "2", "--n-post", "8", "--out", str(tmp_path / "v1")])
    assert code in (0, 1)
    assert [c["gate"] for c in report["checks"]] == list(val.GATES)
    assert "mc_sharpen" not in report["metrics"]
    assert "shuffle_delta_nll" in report["metrics"]

    bad = tmp_path / "bad"
    bad.mkdir()
    cal = json.loads((V4_RELEASE / "calibration.json").read_text())
    cal["config"]["tokens"]["alpha"] = 1.5
    (bad / "calibration.json").write_text(json.dumps(cal))
    shutil.copy(V4_RELEASE / "params.msgpack", bad / "params.msgpack")
    with pytest.raises(FileNotFoundError, match="no stored trigger grid"):
        load_long_bns(bad, device="cpu")
    chirp = tlb.build_chirp_token_grid(duration=16.0, f_hi=256.0)["config"]
    enc = {"d_model": 16, "n_layers": 1, "n_heads": 2, "patch": 4}
    cal["config"].update(tokens=chirp, enc=enc, flow={})
    (bad / "calibration.json").write_text(json.dumps(cal))
    (bad / "params.msgpack").unlink()
    torch.save({"model": tlb.LongBNSNPE(enc=enc, n_feat=11).state_dict()},
               bad / "state.pt")
    model, _, grid = load_long_bns(bad, device="cpu")
    assert grid["config"] == chirp
    assert model.encoder.embed.in_features == 4 * 11


def test_rerun_keeps_a_finished_calibration(tmp_path, monkeypatch):
    """A run started in a finished run's directory without --resume moves
    the old calibration.json (not a "pending" record) to
    calibration.prev.json before it writes its own pending record, so that
    a run killed before its end-of-run battery leaves the old record
    intact; a pending record is not kept."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    old = json.loads((V4_RELEASE / "calibration.json").read_text())
    (run_dir / "calibration.json").write_text(json.dumps(old))

    def killed(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(tool, "val_metrics", killed)
    with pytest.raises(KeyboardInterrupt):
        tool.run_training(TINY + ["--outdir", str(run_dir), "--steps", "2",
                                  "--eval-every", "1"])
    assert json.loads((run_dir / "calibration.json").read_text())["pending"]
    assert json.loads(
        (run_dir / "calibration.prev.json").read_text()) == old
    # a second killed start: the pending record is replaced, the finished
    # one stays where the first start put it
    with pytest.raises(KeyboardInterrupt):
        tool.run_training(TINY + ["--outdir", str(run_dir), "--steps", "2",
                                  "--eval-every", "1"])
    assert json.loads(
        (run_dir / "calibration.prev.json").read_text()) == old
