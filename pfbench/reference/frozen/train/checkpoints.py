"""Released models' weights and configs.

Port of posteriflow_tpu/train/checkpoints.py:32-118, without flax and
msgpack: a release's flax tree (params.msgpack, decoded by
utils/msgpack_lite.py) is carried into a torch state_dict by
`flax_to_state_dict`; `flax_view` goes back, leaf by leaf, to the flax
layout, which the adaptive clip's per-unit norms need. meta.json's config
becomes an NPEConfig (`cfg_from_dict`) or a TrainConfig
(`train_cfg_from_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from pfbench.reference.frozen.models.encoder import (
    MultiHeadDotProductAttention)
from pfbench.reference.frozen.models.npe import NPEConfig
from pfbench.reference.frozen.physics.simulator import sim_config_from_dict

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


def train_cfg_from_dict(d: dict):
    """A saved train config (the `config` of a meta.json) -> TrainConfig,
    with NPEConfig, SimConfig and PriorConfig rebuilt (JSON lists back to
    tuples); keys the port does not know raise."""
    from pfbench.reference.frozen.train.trainer import TrainConfig  # imports us
    rest = {k: v for k, v in d.items() if k not in ("npe", "sim")}
    return TrainConfig(npe=cfg_from_dict(d), sim=sim_config_from_dict(d["sim"]),
                       **rest)
