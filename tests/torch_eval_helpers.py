"""Shared piece of the evaluation slice's tests (tests/test_torch_eval_*):
port training checkpoints of the small test configs."""

from pathlib import Path

import torch

from posteriflow_torch.train.checkpoints import CheckpointManager
from posteriflow_torch.train.trainer import init_state
from torch_train_helpers import CONFIGS, port_config


def port_checkpoint(root: Path, kind: str) -> Path:
    """A port training checkpoint root <root>/<kind> holding "best" (epoch
    1) of the test config CONFIGS[kind] ("conv": 11-D, "coherent": 15-D
    precessing), from a seeded fresh init."""
    cfg = port_config(CONFIGS[kind])
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    CheckpointManager(root / kind).save("best", state, cfg, epoch=1)
    return root / kind
