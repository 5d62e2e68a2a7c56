"""The traced frames' operations (`counts.render_frame.frame_flops`, on the
pairs of each pose they visited) over their span (CUDA events around the
traced requests, `traced`) at the card's float32 peak, the peak
`mfu_pct.train` uses."""
from perfbench.counts.peaks import FP32_FLOPS
from perfbench.reading import mean_span


def read(trace):
    flops, frames = trace.counts.get("frame_flops"), trace.counts.get("frames")
    span = mean_span(trace.spans, "traced")
    if not flops or not frames or not span:
        return None
    return 100.0 * frames * flops / (span / 1e3 * FP32_FLOPS)
