"""The encoder: CUDA events around the encode call, mean a request."""

from pfbench.harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "encode")
