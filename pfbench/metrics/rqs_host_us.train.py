"""The spline wrappers' host time a call (`pf.rqs` forward and
`pf.rqs.grad` backward together), in the traced steps."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.host_us_per_call(ps.snapshot(), ("pf.rqs", "pf.rqs.grad"))
