"""The simulator's noise and assembly (`pf.sim.crops`, the bank's crops,
and `pf.sim.assemble`: recolouring, the transform to the time domain,
glitches, dropout): device ms a step, from the program's spans in the
traced steps."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.TRAIN_UNIT,
                       ("pf.sim.crops", "pf.sim.assemble"), "device_ms")
