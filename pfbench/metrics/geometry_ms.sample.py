"""The coherent encoder's geometry tokens (`pf.encoder.geometry`):
profiled stream time a request, from the program's spans in the traced
requests.

Stream time runs from the span's start event to its end event, idle
included. Its ~160 small operators are paced by the host, so under the
profiler this reads the profiled host's dispatch, not the device's
work."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.SAMPLE_UNIT,
                       ("pf.encoder.geometry",), "device_ms")
