"""The share of a unit's untraced time with nothing running on the
device (readers.idle_pct)."""

from pfbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
