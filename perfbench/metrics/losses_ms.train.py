"""Host milliseconds per training step of the 8 losses (the
`g4s:train.losses` span around `losses_from_render`)."""
from perfbench.program_spans import STEP, per


def read(trace):
    return per(trace.host_annotations, "g4s:train.losses", STEP)
