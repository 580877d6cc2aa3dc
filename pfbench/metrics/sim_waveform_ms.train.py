"""The simulator's waveforms (`pf.sim.waveform`: the amplitude-only gate
SNR, the waveforms, the gate, the slot sum): profiled stream time a step,
from the program's spans in the traced steps.

Stream time runs from the span's start event to its end event, idle
included. The waveforms' ~3,000 small operators are paced by the host, so
under the profiler this reads the profiled host's dispatch, not the
device's work: work taken off the device need not show here, and
operators taken off the host show larger than they are untraced."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.TRAIN_UNIT, ("pf.sim.waveform",),
                       "device_ms")
