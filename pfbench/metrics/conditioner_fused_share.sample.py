"""The share of the flow's conditioner calls that ran the fused CUDA tail
(ops/conditioner_cuda.py): the program's `conditioner_fused` count over
the calls of `pf.flow.conditioner`, from the program's spans in the
traced requests. A program that counts neither way of the conditioner
(`conditioner_fused`, `conditioner_eager`) reads None."""

from pfbench.harness import program_spans as ps

WAYS = ("conditioner_fused", "conditioner_eager")


def read(run):
    cond = ps.snapshot().get("pf.flow.conditioner")
    if not cond or not cond["calls"]:
        return None
    counts = cond["counts"]
    if not any(w in counts for w in WAYS):
        return None
    return counts.get("conditioner_fused", 0) / cond["calls"]
