"""The share of the coherent encoder's calls that replayed its CUDA
graphs: the program's `encoder_graph_replay` count over the calls of
`pf.encoder`, from the program's spans in the traced requests. A program
that counts none of its served encoder's ways (`encoder_eager`,
`encoder_graph_capture`, `encoder_graph_replay`) reads None."""

from pfbench.harness import program_spans as ps

WAYS = ("encoder_eager", "encoder_graph_capture", "encoder_graph_replay")


def read(run):
    enc = ps.snapshot().get("pf.encoder")
    if not enc or not enc["calls"]:
        return None
    counts = enc["counts"]
    if not any(w in counts for w in WAYS):
        return None
    return counts.get("encoder_graph_replay", 0) / enc["calls"]
