"""The flow: CUDA events around the sampling call (base draws through
the coupling inverse, wrap, denormalisation), mean a request."""

from pfbench.harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "flow")
