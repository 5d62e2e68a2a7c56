"""Device milliseconds of both heads on one chunk (CUDA events from the
first head's forward pre-hook to the second's forward hook)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "heads")
