"""Operations and bytes computed from shapes: the yardstick's arithmetic.

`rqs.py` holds the spline kernels' bytes; one module a configuration
(named as its file under pfbench/configs) holds the matrix-product FLOPs
of the work a unit of its cells does. A driver reaches its configuration's
module by name (`for_config`)."""

from __future__ import annotations

import importlib
from types import ModuleType


def for_config(name: str) -> ModuleType:
    return importlib.import_module(f"pfbench.counts.{name}")
