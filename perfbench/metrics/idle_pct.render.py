"""Share of the traced frames' span with no operation on the device: 1 −
busy / span, the span from the CUDA event before the first traced request
to the one after the last (`traced`), so the profiler's own start and stop,
which `Trace.window_s` holds, are left out."""
from perfbench.reading import mean_span


def read(trace):
    span = mean_span(trace.spans, "traced")
    if not span or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / (span / 1e3))
