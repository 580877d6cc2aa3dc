"""The gradient norms and the optimizer (`pf.train.grad_norms` and
`pf.train.adamw`: clip and AdamW): device ms a step, from the program's
spans in the traced steps."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.per_unit(ps.snapshot(), ps.TRAIN_UNIT,
                       ("pf.train.grad_norms", "pf.train.adamw"), "device_ms")
