"""Device milliseconds of one `AsymmetricMASt3R.encode` call, one per
chunk of a set (CUDA events around it)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "encoder")
