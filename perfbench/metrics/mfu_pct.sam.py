"""The work the traced set needs (`counts.sam.view_flops` per view: the
published encoder's products and convolutions, padded windows counted as
the published model computes them) over the set's span (CUDA events around
it, `traced`) at the card's dense TF32 peak, as `mfu_pct.mast3r` takes it."""
from perfbench.counts.peaks import TF32_FLOPS
from perfbench.reading import mean_span


def read(trace):
    flops = trace.counts.get("window_flops")
    span = mean_span(trace.spans, "traced")
    if not flops or not span:
        return None
    return 100.0 * flops / (span / 1e3 * TF32_FLOPS)
