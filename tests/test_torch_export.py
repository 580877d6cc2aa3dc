"""The release path back to the JAX package: msgpack_lite.packb,
train/checkpoints.state_dict_to_flax and CheckpointManager.load_release,
tools/export_release.py and fit_priority's priority_params.msgpack.

Byte equality: packb(unpackb(b)) == b for every committed release file,
and a released model loaded into the port and exported again is its
committed params.msgpack byte for byte. JAX's own loaders
(CheckpointManager.load_release, load_priority_net) read what the port
writes and give the port's outputs within 1e-5 absolute (NLLs of ~12
nats, scores and sigmas up to ~10; the float32 weights are the same bits,
the two packages' float32 ops round differently: 1e-6 read on the CPU).
"""

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import posteriflow_tpu.train.checkpoints as jckpt
from posteriflow_torch.models.npe import LeanNPE
from posteriflow_torch.train.checkpoints import (CheckpointManager,
                                                 state_dict_to_flax,
                                                 write_params)
from posteriflow_torch.utils import msgpack_lite
from posteriflow_torch.utils.msgpack_lite import packb, unpackb
from torch_overlap_helpers import one_torch_thread  # noqa: F401
from torch_overlap_helpers import scenario
from torch_train_helpers import CONFIGS, _jit_init, batches, port_config

ROOT = Path(__file__).resolve().parents[1]
RELEASE_FILES = sorted((ROOT / "model_release").glob("*/*.msgpack"))
NLL_TOL = SCORE_TOL = 1e-5


def test_all_thirteen_release_files_are_covered():
    assert len(RELEASE_FILES) == 13


@pytest.mark.parametrize("path", RELEASE_FILES,
                         ids=lambda p: p.parent.name)
def test_packb_rewrites_every_release_byte_for_byte(path):
    data = path.read_bytes()
    assert packb(unpackb(data)) == data


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 1.5, -0.0, None, True, False, "", "a" * 31, "a" * 32,
    "é" * 200, "a" * 70000, b"", b"x" * 300, b"y" * 70000, [], [1] * 15,
    [1] * 16, [[1, "a"], {"k": 2.0}], {str(i): i for i in range(16)}])
def test_packb_scalars_equal_msgpack_python(value):
    """msgpack-python's packb(use_bin_type=True), which flax calls."""
    assert packb(value) == msgpack.packb(value, use_bin_type=True)


def test_packb_arrays_are_flax_ext_type_1():
    from flax.serialization import msgpack_serialize
    tree = {"b": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "a": np.full((), 2.5, np.float32),
            "c": np.arange(3, dtype=np.int64)}
    assert packb(tree) != msgpack_serialize(tree)        # key order
    ordered = {k: tree[k] for k in sorted(tree)}
    assert packb(ordered) == msgpack_serialize(tree)


def test_packb_refuses_what_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(msgpack_lite, "_CHUNK_BYTES", 16)
    with pytest.raises(ValueError, match="chunk"):
        packb({"w": np.zeros(5, np.float32)})
    with pytest.raises(ValueError):
        packb({"w": object()})


@pytest.mark.parametrize("name", ["npe_r7_best", "npe_r2_best"])
def test_release_reexported_byte_for_byte(name, tmp_path):
    """The flagship (bfloat16 flow, 15-D) and npe_r2_best (float32
    encoder, 11-D) loaded into the port and written again."""
    release = ROOT / "model_release" / name
    model, cfg, meta = CheckpointManager.load_release(release, device="cpu")
    assert cfg.npe.n_params == (15 if name == "npe_r7_best" else 11)
    data = write_params(model, tmp_path / "params.msgpack")
    assert data == (release / "params.msgpack").read_bytes()


def test_priority_release_reexported_byte_for_byte():
    from posteriflow_torch.train.train_priority import load_priority_net
    d = ROOT / "model_release" / "priority_v7"
    net = load_priority_net(d, device="cpu")
    assert packb(state_dict_to_flax(net)) == \
        (d / "priority_params.msgpack").read_bytes()


def _jit_load_release(monkeypatch):
    """JAX's load_release with its parameter template from a jitted init
    (flax's eager init of the encoder takes ~20 s on the CPU)."""
    monkeypatch.setattr(jckpt, "init_state", lambda key, cfg:
                        types.SimpleNamespace(params=_jit_init(cfg)(key)))
    return jckpt.CheckpointManager.load_release


def _trained_tiny(tmp_path, steps: int = 3):
    """The conv test config trained a few port steps on the CPU, saved as a
    checkpoint (ckpt/best) -> (root, model, cfg)."""
    from posteriflow_torch.train.trainer import init_state, train_step
    cfg = port_config(CONFIGS["conv"])
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    for _, tb in batches(CONFIGS["conv"], steps, 4, seed=5):
        train_step(state, tb)
    root = tmp_path / "ckpt"
    CheckpointManager(root).save("best", state, cfg, {"val_nll": 1.0},
                                 epoch=1)
    return root, state.model, cfg


def test_jax_load_release_reads_a_port_export(tmp_path, monkeypatch):
    """tools/export_release.py on a port checkpoint; JAX's
    CheckpointManager.load_release reads it and its NLL on fixed inputs
    is the port's within NLL_TOL."""
    from posteriflow_tpu.models.npe import LeanNPE as JNPE
    from posteriflow_torch.tools import export_release
    root, model, cfg = _trained_tiny(tmp_path)
    run = tmp_path / "run"
    run.mkdir()
    (run / "history.json").write_text(json.dumps([{"epoch": 1}]))
    out = export_release.main(["--ckpt", str(root), "--run-dir", str(run),
                               "--out", str(tmp_path / "rel"),
                               "--init-from", "model_release/x",
                               "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [
        "history.json", "meta.json", "params.msgpack"]
    meta = json.loads((out / "meta.json").read_text())
    assert set(meta) == {"config", "epoch", "metrics"}
    assert meta["metrics"]["init_from"] == "model_release/x"

    params, jcfg, jmeta = _jit_load_release(monkeypatch)(out)
    assert jcfg == CONFIGS["conv"] and jmeta["epoch"] == 1
    jb, tb = batches(CONFIGS["conv"], 1, 4, seed=9)[0]
    ranks = np.zeros(4, np.int64)
    theta = tb.params[:, 0]
    with torch.no_grad():
        t_nll = model.nll(tb.strain, theta, torch.from_numpy(ranks),
                          tb.asd_bands).numpy()
    j_nll = jax.jit(lambda p, s, t, r: JNPE(jcfg.npe).apply(p, s, t, r))(
        params, jb.strain, jnp.asarray(theta.numpy()), jnp.asarray(ranks))
    assert np.abs(t_nll - np.asarray(j_nll)).max() <= NLL_TOL

    # the port's own loader gives the checkpoint's model, bit for bit
    again, cfg2, _ = CheckpointManager.load_release(out, device="cpu")
    assert cfg2 == cfg
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_export_warns_without_ood_stats_and_copies_them(tmp_path, capsys):
    from posteriflow_torch.tools import export_release
    root, _, _ = _trained_tiny(tmp_path, steps=1)
    export_release.main(["--ckpt", str(root), "--out",
                         str(tmp_path / "a"), "--device", "cpu"])
    assert "ood_stats.npz missing" in capsys.readouterr().err
    np.savez(root / "ood_stats.npz", mean=np.zeros(3))
    export_release.main(["--ckpt", str(root), "--out",
                         str(tmp_path / "b"), "--device", "cpu"])
    assert (tmp_path / "b" / "ood_stats.npz").read_bytes() == \
        (root / "ood_stats.npz").read_bytes()


def test_jax_load_priority_net_reads_fit_priority(tmp_path, monkeypatch):
    """fit_priority writes priority_params.msgpack; JAX's
    load_priority_net reads it (with net.json) and scores within
    SCORE_TOL of the port's net."""
    import posteriflow_tpu.train.train_priority as jtp
    from posteriflow_tpu.models.priority_net import PriorityNet as JNet
    from posteriflow_torch.train import train_priority as tp
    cfg = tp.PriorityTrainConfig(batch_size=4, max_signals=3, d_model=32,
                                 use_dt=True, residual_snr=True)
    net, _ = tp.fit_priority(tmp_path, cfg, steps=2, eval_every=1,
                             device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "history.json", "net.json", "priority_params.msgpack"]

    init = JNet.init
    monkeypatch.setattr(JNet, "init", lambda self, key, *a, with_aux, **kw:
                        jax.jit(lambda k, *aa, **kk: init(
                            self, k, *aa, with_aux=with_aux, **kk))(
                                key, *a, **kw))
    jnet, jparams = jtp.load_priority_net(
        tmp_path / "priority_params.msgpack")
    segs, params, mask, snr = scenario(4)
    with torch.no_grad():
        t_scores, t_sigma = net(*(torch.from_numpy(a)
                                  for a in (segs, params, mask)),
                                snr_est=torch.from_numpy(snr))
    j_scores, j_sigma = jax.jit(lambda p, s, c, m, e: jnet.apply(
        p, s, c, m, snr_est=e))(jparams, *(jnp.asarray(a) for a in
                                          (segs, params, mask, snr)))
    live = mask > 0
    for a, b in ((t_scores, j_scores), (t_sigma, j_sigma)):
        a, b = a.numpy()[live], np.asarray(b)[live]
        assert np.abs(a - b).max() <= SCORE_TOL
    again = tp.load_priority_net(tmp_path, device="cpu")
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_release_builds_the_model_on_the_device():
    model, cfg, meta = CheckpointManager.load_release(
        ROOT / "model_release" / "npe_r2_best", device="cpu")
    assert isinstance(model, LeanNPE) and not model.training
    assert next(model.parameters()).device.type == "cpu"
    assert cfg.npe == model.cfg and "epoch" in meta
