"""Host milliseconds of one `Trainer.densify` call (its `g4s:train.densify`
span, with no synchronize added): the program's own counterpart of
`densify_ms.train`."""
from perfbench.program_spans import mean


def read(trace):
    return mean(trace.host_annotations, "g4s:train.densify")
