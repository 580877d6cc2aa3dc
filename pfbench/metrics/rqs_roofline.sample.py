"""rqs_tile (forward or inverse) in the traced requests: the byte bound
at the HBM peak over its device time from the profiler."""

from pfbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, ("rqs_tile_bytes",), "rqs_tile")
