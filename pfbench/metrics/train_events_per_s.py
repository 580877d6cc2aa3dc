"""Events trained on in whole steps (simulate, encode, NLL, backward,
clip, AdamW) in the window over the window."""

from pfbench.harness.readers import rate


def read(run):
    return rate(run, "events")
