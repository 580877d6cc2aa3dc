"""95th percentile of every request in the window: from its strain on
the host handed in to its draws on the host. Host clock."""

from pfbench.harness.readers import percentile_ms


def read(run):
    return percentile_ms(run, 95.0)
