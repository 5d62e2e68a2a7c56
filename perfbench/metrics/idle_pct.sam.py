"""Share of the traced set's span with no operation on the device: 1 −
busy / span, the span from the CUDA event before the set's encoder calls to
the one after its embeddings' check (`traced`), as `idle_pct.mast3r`."""
from perfbench.reading import mean_span


def read(trace):
    span = mean_span(trace.spans, "traced")
    if not span or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / (span / 1e3))
