"""Device milliseconds of both decoders on one chunk (CUDA events from the
first decoder block's forward pre-hook to the last one's forward hook)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "decoder")
