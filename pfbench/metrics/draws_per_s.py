"""Posterior draws returned to the host in the window over the window."""

from pfbench.harness.readers import rate


def read(run):
    return rate(run, "draws")
