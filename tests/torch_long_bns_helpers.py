"""Shared pieces of the long-BNS parity tests (tests/test_torch_long_bns_*.py):
the release's tokens config, JAX's trigger grid (built by JAX on the CPU,
as the JAX package builds it), the small test model's config and its
weights carried from a jitted flax init.

The stored grid of a release (posteriflow_torch/models/grids/) was written
by `export_stored_grid`:

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
        import torch_long_bns_helpers as h; h.export_stored_grid()"
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np

from posteriflow_tpu.models.long_bns import \
    build_trigger_token_grid as jax_build_grid
from posteriflow_torch.models import long_bns as tlb
from posteriflow_torch.train.checkpoints import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
V4_RELEASE = REPO / "model_release" / "long_bns_v4"
V1_RELEASE = REPO / "model_release" / "long_bns_v1"
# the JAX tests' small grid (tests/test_long_bns.py:281-286)
TEST_TOKENS = {"duration": 16.0, "f_hi": 256.0, "pad_multiple": 32}
# the small model of the tests: d_model 32, 1 layer, 4 heads, 2 flow
# layers, K = 12
SMALL_ENC = dict(d_model=32, n_layers=1, n_heads=4, context_dim=16, patch=4)
SMALL_FLOW = dict(flow_layers=2, flow_hidden=32, flow_bins=12)


def release_tokens_cfg() -> dict:
    """The `tokens` config of long_bns_v4's calibration.json."""
    cal = json.loads((V4_RELEASE / "calibration.json").read_text())
    return cal["config"]["tokens"]


@functools.lru_cache(maxsize=None)
def _jax_grid(items) -> dict:
    return jax_build_grid(**dict(items))


def jax_grid(**cfg) -> dict:
    """JAX's build_trigger_token_grid(**cfg) (cached: ~5 s each)."""
    return _jax_grid(tuple(sorted(cfg.items())))


def export_stored_grid():
    """Write JAX's grid for long_bns_v4's tokens config into the port's
    grids/ directory."""
    tok = release_tokens_cfg()
    grid = jax_grid(**{k: v for k, v in tok.items() if k != "kind"})
    assert grid["config"] == tok
    return tlb.save_grid(grid, tlb.stored_grid_path(tok))


def carry_params(params) -> dict:
    """A flax parameter tree (JAX arrays) -> the port's state_dict."""
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
