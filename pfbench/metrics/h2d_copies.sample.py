"""Copies from pageable host memory to the card that the program makes
(`h2d_pageable`, counted where it copies), a request."""

from pfbench.harness import program_spans as ps


def read(run):
    return ps.count_per_unit(ps.snapshot(), ps.SAMPLE_UNIT, "h2d_pageable")
