"""The simulator: CUDA events around simulate_batch, mean a step."""

from pfbench.harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "simulate")
