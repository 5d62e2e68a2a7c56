"""Milliseconds of one `bin_splats` call in the viewer's frames, on the
device's timeline (its `g4s:render.binning` span, from the first operation
launched inside to the last one's end)."""
from perfbench.program_spans import mean


def read(trace):
    return mean(trace.annotations, "g4s:render.binning")
