"""The spline wrapper's host time a call (`pf.rqs`: checks, contiguity
copies, plan and launch), in the traced requests."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.host_us_per_call(ps.snapshot(), ("pf.rqs",))
