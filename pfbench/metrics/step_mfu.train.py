"""A step's matrix-product FLOPs at the configuration's shapes,
forward and backward, over the window at the dense bf16 peak."""

from pfbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
