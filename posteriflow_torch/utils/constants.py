"""Constant tensors built once per device.

A tensor made from host data on the card is a copy that waits for the
device; the simulator's grids and tables are the same every call, so they
are made once per (name, device) and kept.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import torch

_CONSTANTS: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(name: Hashable, device,
                    build: Callable[[], torch.Tensor]) -> torch.Tensor:
    """The tensor `build()` on `device`, made on the first call for
    (name, device) and returned from then on."""
    key = (name, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = build().to(key[1])
    return _CONSTANTS[key]
