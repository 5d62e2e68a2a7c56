"""B1's share of its roofline in the viewer's frames: the least time for
the traced frames' forward passes without the distortion channel
(`counts.raster.b1_work` on the pairs of each pose the traced frames
visited) over B1's device time in the trace."""
from perfbench.reading import device_time

KERNELS = (r"\brasterize_fwd_kernel\b",)


def read(trace):
    secs, n = device_time(trace.kernels, KERNELS)
    least = trace.counts.get("b1_least_s")
    if not n or not secs or not least:
        return None
    return 100.0 * n * least / secs
