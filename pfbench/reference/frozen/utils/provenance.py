"""The config hash that names a long-BNS release's stored trigger grid.

Port of posteriflow_tpu/utils/provenance.py:24-78: the hash is taken over
the JSON of a config with sorted keys.
"""

from __future__ import annotations

import hashlib
import json


def config_hash(cfg_dict: dict) -> str:
    """Stable 12-hex digest of a (JSON-serializable) config dict."""
    return hashlib.sha256(
        json.dumps(cfg_dict, sort_keys=True).encode()).hexdigest()[:12]
