"""Milliseconds of the 32 blocks' MLPs per encoder call on the device's
timeline: the program's `g4s:sam.mlp` spans summed over the traced set, over
its `g4s:sam.encode` spans."""
from perfbench.program_spans import per


def read(trace):
    return per(trace.annotations, "g4s:sam.mlp", "g4s:sam.encode")
