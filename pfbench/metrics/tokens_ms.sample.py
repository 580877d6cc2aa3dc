"""Long-BNS heterodyned trigger tokens (`pf.lbns.tokens`): profiled
stream time a request, from the program's spans in the traced requests.

Stream time runs from the span's start event to its end event, idle
included. Where the host sets the pace, as here under the profiler, it
reads the profiled host's dispatch, not the device's work."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.SAMPLE_UNIT, ("pf.lbns.tokens",),
                       "device_ms")
