"""Blocking reads from the card to the host per training step: the
`g4s:sync.*` spans over the `g4s:train.step` spans."""
from perfbench.program_spans import STEP, SYNC, prefixed


def read(trace):
    steps = len(trace.host_annotations.get(STEP, ()))
    return len(prefixed(trace.host_annotations, SYNC)) / steps if steps else None
