"""The share of the simulator's waveform calls that ran the CUDA kernels
(ops/waveform_cuda.py): the program's `waveform_fused` count over the
calls of `pf.sim.waveform`, from the program's spans in the traced steps.
A program that counts neither way of the waveforms (`waveform_fused`,
`waveform_eager`) reads None."""

from pfbench.harness import program_spans as ps

WAYS = ("waveform_fused", "waveform_eager")


def read(run):
    wave = ps.snapshot().get("pf.sim.waveform")
    if not wave or not wave["calls"]:
        return None
    counts = wave["counts"]
    if not any(w in counts for w in WAYS):
        return None
    return counts.get("waveform_fused", 0) / wave["calls"]
