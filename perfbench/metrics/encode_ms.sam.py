"""Device milliseconds of one SAM image-encoder call, one per slab of views
(CUDA events from the encoder's forward pre-hook to its forward hook)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "encode")
