"""Artifact provenance: every model-specific analysis artifact names the
checkpoint (and config hash) that generated it.

Port of posteriflow_tpu/utils/provenance.py:24-78. The hash is taken over
the JSON of the saved train config with sorted keys, so a port checkpoint
of a release's config carries the release's hash.

Usage (artifact generators):
    report["_meta"] = artifact_meta(ckpt_dir_or_release)

Usage (consumers / release checklist):
    check_artifact_matches(bias_map_meta, release_dir)  -> raises on drift
"""

from __future__ import annotations

import datetime
import hashlib
import json
from pathlib import Path


def config_hash(cfg_dict: dict) -> str:
    """Stable 12-hex digest of a (JSON-serializable) config dict."""
    return hashlib.sha256(
        json.dumps(cfg_dict, sort_keys=True).encode()).hexdigest()[:12]


def _load_config_dict(ckpt: str | Path) -> dict | None:
    """config dict from a release dir (meta.json) or a CheckpointManager
    entry dir (<ckpt>/<name>/meta.json or <ckpt>/meta.json)."""
    p = Path(ckpt)
    for cand in (p / "meta.json", p / "best" / "meta.json"):
        if cand.exists():
            try:
                return json.loads(cand.read_text()).get("config")
            except (json.JSONDecodeError, OSError):
                return None
    return None


def artifact_meta(ckpt: str | Path, **extra) -> dict:
    """Provenance block for an analysis artifact: checkpoint path, config
    hash (when resolvable), UTC timestamp, plus any extra fields."""
    meta = {"ckpt": str(ckpt),
            "generated_utc": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds")}
    cfg = _load_config_dict(ckpt)
    if cfg is not None:
        meta["config_hash"] = config_hash(cfg)
    meta.update(extra)
    return meta


def check_artifact_matches(artifact_meta_block: dict | None,
                           release: str | Path,
                           artifact_name: str = "artifact") -> None:
    """Raise ValueError when an artifact's recorded config hash does not
    match the release it is being armed for (a model-specific bias map must
    be regenerated per flagship)."""
    if not artifact_meta_block:
        raise ValueError(
            f"{artifact_name} carries no _meta provenance block — "
            "regenerate it with the current scripts")
    cfg = _load_config_dict(release)
    want = artifact_meta_block.get("config_hash")
    if want is None:
        raise ValueError(
            f"{artifact_name} records no config_hash — it predates the "
            "provenance contract; regenerate it on the current flagship")
    if cfg is not None and config_hash(cfg) != want:
        raise ValueError(
            f"{artifact_name} was generated on "
            f"{artifact_meta_block.get('ckpt')} (config {want}) but is "
            f"being armed for {release} (config {config_hash(cfg)}): "
            "regenerate the artifact on the current flagship")
