"""Checkpoints of the port: released models and training checkpoints.

Port of posteriflow_tpu/train/checkpoints.py:32-118, without flax, msgpack
and orbax:

  - a release (params.msgpack + meta.json) is decoded by
    utils/msgpack_lite.py and its flax tree carried into a torch state_dict
    by `flax_to_state_dict` (`load_release`); `flax_view` goes back, leaf
    by leaf, to the flax layout, and `state_dict_to_flax` carries a whole
    model back into flax's tree, which `msgpack_lite.packb` writes as
    flax does (tools/export_release.py);
  - a training checkpoint is `<root>/<name>/state.pt` (the model's
    state_dict, the optimizer's moments and its step) beside `meta.json`
    in the JAX package's schema (the whole TrainConfig, the epoch and the
    metrics). Orbax's format is not read.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from posteriflow_torch.models.encoder import MultiHeadDotProductAttention
from posteriflow_torch.models.npe import NPEConfig
from posteriflow_torch.physics.simulator import sim_config_from_dict
from posteriflow_torch.utils.msgpack_lite import packb, unpackb

_MHA_PROJ = ("query", "key", "value")
# the DenseGeneral projections of long-BNS attention
# (posteriflow_tpu/models/long_bns.py:223-232)
_LB_PROJ = ("q", "k", "v")
_HEAD_OUT = ("out", "o")


def cfg_from_dict(d: dict) -> NPEConfig:
    """The `npe` part of a saved train config -> NPEConfig. JSON lists come
    back as tuples for the fields whose default is a tuple; keys the port
    does not know raise."""
    npe = dict(d["npe"])
    for f in dataclasses.fields(NPEConfig):
        if isinstance(npe.get(f.name), list) and isinstance(f.default, tuple):
            npe[f.name] = tuple(npe[f.name])
    return NPEConfig(**npe)


def _flatten(tree: dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """A flax LeanNPE parameter tree (nested dicts of numpy arrays, with or
    without the top-level "params") -> the port's state_dict.

    Dense kernels [in, out] are transposed to [out, in]; Conv kernels go
    from [k, in, out] to [out, in, k]; the DenseGeneral kernels of
    attention are reshaped: query/key/value (long-BNS: q/k/v) [in, heads,
    hd] -> [heads·hd, in], out (long-BNS: o) [heads, hd, out] -> [out,
    heads·hd], and their [heads, hd] biases are flattened. LayerNorm
    `scale` (auto-named LayerNorm_i included) and Embed `embedding` become
    `weight`."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for path, a in _flatten(params).items():
        *mods, leaf = path
        parent = mods[-1] if mods else ""
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif parent in _MHA_PROJ + _LB_PROJ:
                a = a.reshape(a.shape[0], -1).T
            elif parent in _HEAD_OUT:
                a = a.reshape(-1, a.shape[-1]).T
            elif parent.startswith("Conv"):
                a = a.transpose(2, 1, 0)
            else:
                raise ValueError(f"no rule for kernel {'/'.join(path)} "
                                 f"{a.shape}")
            leaf = "weight"
        elif leaf == "bias" and parent in _MHA_PROJ + _LB_PROJ:
            a = a.reshape(-1)
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.tensor(np.ascontiguousarray(a))
    return sd


def _flax_leaf(model: nn.Module, name: str,
               t: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
    """The state_dict entry `name` of `model` -> (its flax path, the tensor
    in flax's layout): the inverse of `flax_to_state_dict` for one entry.
    Linear weights become Dense kernels [in, out]; attention projections
    (query/key/value, long-BNS q/k/v) kernels [in, heads, hd] with [heads,
    hd] biases, the output projection (out, long-BNS o) [heads, hd, out];
    Conv1d weights [k, in, out]; LayerNorm weights `scale`, Embedding
    weights `embedding`."""
    mod_path, _, leaf = name.rpartition(".")
    if not mod_path:                        # a parameter of the model itself
        return (leaf,), t
    parent_path, _, child = mod_path.rpartition(".")
    mod = model.get_submodule(mod_path)
    heads = getattr(model.get_submodule(parent_path), "n_heads", None)
    if isinstance(mod, nn.Linear):
        if heads and child in _MHA_PROJ + _LB_PROJ:
            t = (t.T.reshape(t.shape[1], heads, -1) if leaf == "weight"
                 else t.reshape(heads, -1))
        elif heads and child in _HEAD_OUT and leaf == "weight":
            t = t.T.reshape(heads, -1, t.shape[0])
        elif leaf == "weight":
            t = t.T
        leaf = "kernel" if leaf == "weight" else leaf
    elif isinstance(mod, nn.Conv1d) and leaf == "weight":
        t, leaf = t.permute(2, 1, 0), "kernel"
    elif isinstance(mod, nn.LayerNorm) and leaf == "weight":
        leaf = "scale"
    elif isinstance(mod, nn.Embedding) and leaf == "weight":
        leaf = "embedding"
    return tuple(mod_path.split(".")) + (leaf,), t


def _sorted_tree(tree: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def state_dict_to_flax(model: nn.Module) -> dict:
    """The model's parameters -> flax's parameter tree {"params": {...}}
    of float32 numpy arrays, every level in flax's (sorted) key order, the
    layout of each leaf as the JAX package's module has it (`_flax_leaf`).
    packb of the tree is the bytes flax.serialization.to_bytes writes."""
    tree: dict = {}
    for name, t in model.state_dict().items():
        path, a = _flax_leaf(model, name, t.detach())
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = a.to(device="cpu", dtype=torch.float32) \
            .contiguous().numpy().copy()
    return {"params": _sorted_tree(tree)}


def write_params(model: nn.Module, path) -> bytes:
    """Write the model's flax tree to `path` as flax's msgpack (a
    release's params.msgpack); returns the bytes."""
    data = packb(state_dict_to_flax(model))
    Path(path).write_bytes(data)
    return data


def load_release(release_dir) -> Tuple[Dict[str, torch.Tensor], NPEConfig,
                                       dict]:
    """A release directory -> (state_dict, NPEConfig, meta). The model is
    rebuilt from the config saved beside the weights."""
    release_dir = Path(release_dir)
    meta = json.loads((release_dir / "meta.json").read_text())
    cfg = cfg_from_dict(meta["config"])
    tree = unpackb((release_dir / "params.msgpack").read_bytes())
    return flax_to_state_dict(tree), cfg, meta


def load_long_bns(model_dir, device="cuda"):
    """A long-BNS run or release directory -> (model on `device`, the
    `config` of its calibration.json, its token grid or None for v1).

    The config is read exactly as scripts/validate_long_bns.py:102-118
    reads it (long_bns_v1 has no meta.json). The weights are
    params.msgpack (a JAX release) or state.pt (a port run, which also
    holds the grid it trained on as grid.npz). A v4 grid is the
    directory's own grid.npz where there is one, else the stored grid of
    the tokens config (a v4 config without either raises); a v3 (chirp)
    grid is rebuilt from its config."""
    from posteriflow_torch.models import long_bns as lb  # imports us
    model_dir = Path(model_dir)
    cal_cfg = json.loads((model_dir / "calibration.json")
                         .read_text())["config"]
    model = lb.build_model(cal_cfg)
    if (model_dir / "state.pt").is_file():
        sd = torch.load(model_dir / "state.pt", map_location="cpu",
                        weights_only=True)["model"]
    else:
        sd = flax_to_state_dict(unpackb(
            (model_dir / "params.msgpack").read_bytes()))
    model.load_state_dict(sd, strict=True)
    grid = None
    kind = lb.model_config(cal_cfg)["kind"]
    own = model_dir / "grid.npz"
    if kind == "trigger" and own.is_file():
        grid = lb.load_grid(own)
    elif kind in ("trigger", "chirp"):
        grid = lb.load_stored_grid(cal_cfg["tokens"])
    return model.to(device), cal_cfg, grid


def flax_view(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The parameter `name` of `model`, or a tensor of its shape such as its
    gradient, viewed in its flax layout (the inverse of
    `flax_to_state_dict` for one leaf): Dense kernels [in, out], Conv
    kernels [k, in, out], attention q/k/v kernels [in, heads, hd] with
    [heads, hd] biases, the attention output kernel [heads, hd, out]. A
    view: writing to it writes `t`."""
    mod_path, leaf = name.rsplit(".", 1)
    mod = model.get_submodule(mod_path)
    parent_path, _, child = mod_path.rpartition(".")
    parent = model.get_submodule(parent_path)
    if isinstance(mod, nn.Conv1d) and leaf == "weight":
        return t.permute(2, 1, 0)
    if not isinstance(mod, nn.Linear):
        return t
    if isinstance(parent, MultiHeadDotProductAttention):
        h = parent.n_heads
        if child in _MHA_PROJ:
            return (t.T.view(t.shape[1], h, -1) if leaf == "weight"
                    else t.view(h, -1))
        if leaf == "weight":                     # the output projection
            return t.T.view(h, -1, t.shape[0])
        return t
    return t.T if leaf == "weight" else t


def _cfg_to_dict(cfg) -> dict:
    """A TrainConfig -> nested dict of JSON types (tuples as lists)."""
    def enc(x):
        if dataclasses.is_dataclass(x):
            return {f.name: enc(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
        if isinstance(x, tuple):
            return [enc(v) for v in x]
        return x
    return enc(cfg)


def train_cfg_from_dict(d: dict):
    """A saved train config (the `config` of a meta.json) -> TrainConfig,
    with NPEConfig, SimConfig and PriorConfig rebuilt (JSON lists back to
    tuples); keys the port does not know raise."""
    from posteriflow_torch.train.trainer import TrainConfig  # imports us
    rest = {k: v for k, v in d.items() if k not in ("npe", "sim")}
    return TrainConfig(npe=cfg_from_dict(d), sim=sim_config_from_dict(d["sim"]),
                       **rest)


def _read_checkpoint(path: Path, device):
    """-> (the saved dict of state.pt on `device`, TrainConfig, meta) of the
    training checkpoint directory `path`."""
    if not (path / "state.pt").is_file():
        raise FileNotFoundError(f"no training checkpoint at {path} "
                                f"(state.pt)")
    meta = json.loads((path / "meta.json").read_text())
    saved = torch.load(path / "state.pt", map_location=torch.device(device),
                       weights_only=True)
    return saved, train_cfg_from_dict(meta["config"]), meta


def load_checkpoint_model(root, name: str):
    """-> (model state_dict on the CPU, TrainConfig, meta) of the training
    checkpoint <root>/<name>/, for serving: it writes nothing, builds no
    optimizer and draws no random init. FileNotFoundError if there is no
    such checkpoint."""
    saved, cfg, meta = _read_checkpoint(Path(root) / name, "cpu")
    return saved["model"], cfg, meta


def load_npe(path, name: str = "best", device="cuda"):
    """-> (LeanNPE on `device` in eval mode, TrainConfig) from a release
    directory (params.msgpack + meta.json) or from the training checkpoint
    `name` under a CheckpointManager root: the model a tool encodes or
    scores with."""
    from posteriflow_torch.models.npe import LeanNPE
    if (Path(path) / "params.msgpack").exists():
        model, cfg, _ = CheckpointManager.load_release(path, device=device)
        return model, cfg
    state_dict, cfg, _ = load_checkpoint_model(path, name)
    model = LeanNPE(cfg.npe)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), cfg


class CheckpointManager:
    """Named checkpoints under one root: best / last / epoch_XXXX, each a
    directory holding state.pt and meta.json."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self.root.mkdir(parents=True, exist_ok=True)

    def save(self, name: str, state, cfg, metrics: Optional[dict] = None,
             epoch: int = 0):
        """Write `state` (a trainer.TrainState) and its meta.json under
        <root>/<name>/, replacing what was there."""
        path = self.root / name
        tmp = self.root / f".{name}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save({"model": state.model.state_dict(),
                    "opt": state.opt.state_dict(), "step": state.step},
                   tmp / "state.pt")
        meta = {"config": _cfg_to_dict(cfg), "epoch": epoch,
                "metrics": _json_metrics(metrics or {})}
        (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)

    def load_meta(self, name: str) -> dict:
        return json.loads((self.root / name / "meta.json").read_text())

    def restore(self, name: str, device="cuda"):
        """-> (state, cfg, meta): the model rebuilt from the SAVED config,
        its weights, the optimizer's moments and step, on `device`."""
        from posteriflow_torch.train.trainer import init_state
        saved, cfg, meta = _read_checkpoint(self.root / name, device)
        state = init_state(cfg, device=device)
        state.model.load_state_dict(saved["model"], strict=True)
        state.opt.load_state_dict(saved["opt"])
        return state, cfg, meta

    @staticmethod
    def load_release(release_dir, device="cuda"):
        """A release directory (params.msgpack + meta.json) -> (LeanNPE on
        `device` in eval mode, TrainConfig, meta): the model rebuilt from
        the config saved beside the weights
        (posteriflow_tpu/train/checkpoints.py:100-111, which returns the
        flax params in the model's place)."""
        from posteriflow_torch.models.npe import LeanNPE
        state_dict, _, meta = load_release(release_dir)
        cfg = train_cfg_from_dict(meta["config"])
        model = LeanNPE(cfg.npe)
        model.load_state_dict(state_dict, strict=True)
        return model.to(device).eval(), cfg, meta

    def fine_tune_restore(self, name: str, new_cfg, device="cuda"):
        """-> (state, meta): the checkpoint's weights under a FRESH
        optimizer and schedule for `new_cfg`."""
        from posteriflow_torch.train.trainer import make_optimizer
        state, _, meta = self.restore(name, device=device)
        state.cfg = new_cfg
        state.opt = make_optimizer(new_cfg, state.model)
        return state, meta


def _json_metrics(metrics: dict) -> dict:
    """Scalars and arrays of tensors and numpy -> JSON floats and lists."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v
    return conv(metrics)
