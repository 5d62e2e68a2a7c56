"""Device milliseconds per MV-UNet call (CUDA events from its forward
pre- and post-hooks)."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "unet_call")
