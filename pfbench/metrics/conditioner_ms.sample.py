"""The flow's conditioner MLPs (every `pf.flow.conditioner`): device ms
a request, from the program's spans in the traced requests."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.SAMPLE_UNIT,
                       ("pf.flow.conditioner",), "device_ms")
