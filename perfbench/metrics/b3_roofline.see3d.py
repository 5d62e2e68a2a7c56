"""B3's share of its roofline: the least time of the traced UNet calls'
attention launches (`counts.attention`, against dense TF32) over B3's
device time in the trace."""
from perfbench.reading import device_time

KERNELS = (r"\battention_fwd_tc\b", r"\battention_fwd_simt\b")


def read(trace):
    secs, n = device_time(trace.kernels, KERNELS)
    least, calls = trace.counts.get("b3_least_s_per_unet"), trace.counts.get("unet_calls")
    if not n or not secs or not least or not calls:
        return None
    return 100.0 * calls * least / secs
