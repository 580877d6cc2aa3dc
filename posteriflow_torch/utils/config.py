"""TrainConfig from a JSON file or a release's meta.json.

Port of load_config of posteriflow_tpu/utils/config.py:39-52: the file's
keys are merged over TrainConfig()'s defaults, and a key the config does
not have is an error. The port reads JSON only (the card's machine has no
PyYAML); a release's meta.json holds its TrainConfig under "config".
"""

from __future__ import annotations

import json
from pathlib import Path

from posteriflow_torch.train.checkpoints import (_cfg_to_dict,
                                                 train_cfg_from_dict)
from posteriflow_torch.train.trainer import TrainConfig


def load_config(path) -> TrainConfig:
    """A .json TrainConfig (or overrides of it), a release's meta.json, or
    a release directory -> TrainConfig."""
    p = Path(path)
    if p.is_dir():
        p = p / "meta.json"
    if p.suffix in (".yaml", ".yml"):
        raise ValueError(f"{p}: YAML configs need PyYAML, which the port does "
                         f"not use; give the config as JSON")
    raw = json.loads(p.read_text()) or {}
    if isinstance(raw.get("config"), dict):          # a release's meta.json
        raw = raw["config"]
    return train_cfg_from_dict(_deep_merge(_cfg_to_dict(TrainConfig()), raw))


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k not in out:
            raise KeyError(f"unknown config key: {k!r} "
                           f"(valid: {sorted(out)})")
        if isinstance(v, dict) and isinstance(out[k], dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
