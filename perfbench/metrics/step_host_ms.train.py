"""Host milliseconds of one `Trainer.step` call (its `g4s:train.step` span)."""
from perfbench.program_spans import STEP, mean


def read(trace):
    return mean(trace.host_annotations, STEP)
