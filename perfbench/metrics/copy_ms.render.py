"""Milliseconds of a frame's copy to the host (CUDA events around the
`.cpu()` of the colour frame: from the render's last operation to the
copy's return)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "copy")
