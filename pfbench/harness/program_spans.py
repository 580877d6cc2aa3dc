"""What the program's own spans read: the span recorder of
posteriflow_torch/utils/logging.py, for the per-layer metrics that read it.

The recorder is live only while a torch profiler records in the process,
so after a --trace 1 run its snapshot covers the traced units alone. A
figure a unit is a ratio to the calls of the path's entry span
(`pf.flow.sample` a request in a served cell, `pf.train.step` a step), so
a retried empty session changes nothing. A program without the recorder,
or a run in which it recorded none of the spans read, reads None.
"""

from __future__ import annotations

from typing import Iterable, Optional

SAMPLE_UNIT = "pf.flow.sample"
TRAIN_UNIT = "pf.train.step"


def snapshot() -> dict:
    """The recorder's totals by span name ({} without the recorder)."""
    try:
        from posteriflow_torch.utils.logging import snapshot as totals
    except ImportError:
        return {}
    return totals()


def _units(snap: dict, entry: str) -> int:
    return snap.get(entry, {}).get("calls", 0)


def per_unit(snap: dict, entry: str, names: Iterable[str],
             field: str) -> Optional[float]:
    """`field` ("host_ms" or "device_ms") summed over the spans `names`,
    over the calls of `entry`."""
    vals = [snap[n][field] for n in names
            if n in snap and snap[n][field] is not None]
    units = _units(snap, entry)
    if not vals or not units:
        return None
    return sum(vals) / units


def count_per_unit(snap: dict, entry: str, key: str) -> Optional[float]:
    """The count `key` over every span, over the calls of `entry`."""
    units = _units(snap, entry)
    if not units:
        return None
    return sum(v["counts"].get(key, 0) for v in snap.values()) / units


def host_us_per_call(snap: dict, names: Iterable[str]) -> Optional[float]:
    """Host µs a call of the spans `names` together."""
    hits = [snap[n] for n in names if n in snap]
    calls = sum(v["calls"] for v in hits)
    if not calls:
        return None
    return 1e3 * sum(v["host_ms"] for v in hits) / calls
