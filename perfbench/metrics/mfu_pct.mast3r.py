"""The work the traced set needs (`counts.mast3r.set_flops`: each image
encoded once, each ordered pair decoded with both heads, grid matching)
over the set's span (CUDA events around it, `traced`) at the card's dense
TF32 peak, the fastest arithmetic accurate to float32 on this card, as
`mfu_pct.see3d` takes it."""
from perfbench.counts.peaks import TF32_FLOPS
from perfbench.reading import mean_span


def read(trace):
    flops = trace.counts.get("window_flops")
    span = mean_span(trace.spans, "traced")
    if not flops or not span:
        return None
    return 100.0 * flops / (span / 1e3 * TF32_FLOPS)
