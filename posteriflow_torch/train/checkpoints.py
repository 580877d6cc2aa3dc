"""Load a released model (params.msgpack + meta.json) into the port.

Port of the release loader of posteriflow_tpu/train/checkpoints.py
(cfg_from_dict :51-57, load_release :100-110), without flax and msgpack:
the weights are decoded by utils/msgpack_lite.py and the flax tree is
carried into a torch state_dict by `flax_to_state_dict`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from posteriflow_torch.models.npe import NPEConfig
from posteriflow_torch.utils.msgpack_lite import unpackb

_MHA_PROJ = ("query", "key", "value")


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
    attention are reshaped: q/k/v [in, heads, hd] -> [heads·hd, in], out
    [heads, hd, out] -> [out, heads·hd], and their [heads, hd] biases are
    flattened. LayerNorm `scale` and Embed `embedding` become `weight`."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = {}
    for path, a in _flatten(params).items():
        *mods, leaf = path
        parent = mods[-1] if mods else ""
        if leaf == "kernel":
            if a.ndim == 2:
                a = a.T
            elif parent in _MHA_PROJ:
                a = a.reshape(a.shape[0], -1).T
            elif parent == "out":
                a = a.reshape(-1, a.shape[-1]).T
            elif parent.startswith("Conv"):
                a = a.transpose(2, 1, 0)
            else:
                raise ValueError(f"no rule for kernel {'/'.join(path)} "
                                 f"{a.shape}")
            leaf = "weight"
        elif leaf == "bias" and parent in _MHA_PROJ:
            a = a.reshape(-1)
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.tensor(np.ascontiguousarray(a))
    return sd


def load_release(release_dir) -> Tuple[Dict[str, torch.Tensor], NPEConfig,
                                       dict]:
    """A release directory -> (state_dict, NPEConfig, meta). The model is
    rebuilt from the config saved beside the weights."""
    release_dir = Path(release_dir)
    meta = json.loads((release_dir / "meta.json").read_text())
    cfg = cfg_from_dict(meta["config"])
    tree = unpackb((release_dir / "params.msgpack").read_bytes())
    return flax_to_state_dict(tree), cfg, meta
