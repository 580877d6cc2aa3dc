"""The trainer: CUDA events around train_step (NLL, backward, clip,
AdamW), mean a step."""

from pfbench.harness.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "train_step")
