"""rqs_tile forward and rqs_grad in the traced steps: their byte
bounds together at the HBM peak over their device time together."""

from pfbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, ("rqs_tile_bytes", "rqs_grad_bytes"),
                        "rqs_tile", "rqs_grad")
