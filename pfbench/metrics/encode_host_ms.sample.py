"""The encoder's host time a request: `pf.encoder` (the coherent
encoder) or `pf.lbns.tokens` + `pf.lbns.encoder` (long-BNS), host ms
over the calls of `pf.flow.sample`, from the program's spans in the
traced requests."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.SAMPLE_UNIT,
                       ("pf.encoder", "pf.lbns.tokens", "pf.lbns.encoder"),
                       "host_ms")
