"""The backward pass (`pf.train.backward`): profiled stream time a step,
from the program's spans in the traced steps.

Stream time runs from the span's start event to its end event, idle
included. Autograd's ~1,400 operators are paced by the host, so under the
profiler this reads the profiled host's dispatch, not the device's work:
work taken off the device need not show here, and operators taken off
the host show larger than they are untraced."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.TRAIN_UNIT, ("pf.train.backward",),
                       "device_ms")
