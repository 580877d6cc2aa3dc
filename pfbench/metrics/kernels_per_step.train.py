"""Kernels in the profiler's window over the steps traced: a count,
the same in every run of the same code."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or t.units == 0:
        return None
    return len(t.kernels) / t.units
