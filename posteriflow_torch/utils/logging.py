"""Logging for the port's tools.

Port of setup_logging of posteriflow_tpu/utils/logging.py:31-41. The JAX
package also silences absl, orbax and jax there; the port imports none of
them.
"""

from __future__ import annotations

import logging


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    """Root logging at `level` with a timestamped format; returns the
    "posteriflow" logger. force=True: a root logger configured earlier
    would make a plain basicConfig a silent no-op."""
    logging.basicConfig(
        level=level, force=True,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    return logging.getLogger("posteriflow")
