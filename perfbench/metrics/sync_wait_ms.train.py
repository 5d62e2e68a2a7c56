"""Host milliseconds per training step inside the `g4s:sync.*` spans: the
time the host waits for the card at its blocking reads."""
from perfbench.program_spans import STEP, SYNC, prefixed


def read(trace):
    steps = len(trace.host_annotations.get(STEP, ()))
    return sum(prefixed(trace.host_annotations, SYNC)) / steps if steps else None
