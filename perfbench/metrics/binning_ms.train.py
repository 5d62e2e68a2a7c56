"""Device milliseconds per `bin_splats` call (CUDA events around it)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "binning")
