"""B2's share of its roofline: the least time for the traced steps' backward
passes (`counts.raster.b2_work`) over the device time of B2's three
launches per backward."""
from perfbench.reading import device_time

KERNELS = (r"\btile_walk_kernel\b", r"\btile_order_kernel\b", r"\bwalk_kernel\b")


def read(trace):
    secs, _ = device_time(trace.kernels, KERNELS)
    _, n = device_time(trace.kernels, (r"\bwalk_kernel\b",))
    least = trace.counts.get("b2_least_s")
    if not n or not secs or not least:
        return None
    return 100.0 * n * least / secs
