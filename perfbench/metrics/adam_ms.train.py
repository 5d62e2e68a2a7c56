"""Host milliseconds per training step of the Adam step and the densify
statistics (the `g4s:train.adam` span)."""
from perfbench.program_spans import STEP, per


def read(trace):
    return per(trace.host_annotations, "g4s:train.adam", STEP)
