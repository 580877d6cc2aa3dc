"""A request's matrix-product FLOPs at the configuration's shapes
over the window at the dense bf16 peak."""

from pfbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
