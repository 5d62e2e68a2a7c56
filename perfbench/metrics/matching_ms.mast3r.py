"""Milliseconds of one pair's `extract_correspondences` (CUDA events
around the call, which ends on the host)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "matching")
