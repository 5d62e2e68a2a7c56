"""B1's share of its roofline: the least time for the traced steps' forward
passes (`counts.raster.b1_work` on the pairs of the scene at the traced
window's ends) over B1's device time in the trace."""
from perfbench.reading import device_time

KERNELS = (r"\brasterize_fwd_kernel\b",)


def read(trace):
    secs, n = device_time(trace.kernels, KERNELS)
    least = trace.counts.get("b1_least_s")
    if not n or not secs or not least:
        return None
    return 100.0 * n * least / secs
