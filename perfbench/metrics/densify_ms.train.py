"""Host milliseconds per `Trainer.densify` call, synchronized on both sides."""
from perfbench.reading import mean_span


def read(trace):
    return mean_span(trace.spans, "densify")
