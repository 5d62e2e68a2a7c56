"""Blocking reads from the card to the host per viewer frame: the
`g4s:sync.*` spans over the traced frames (the frame's own copy to the
host is not one of them)."""
from perfbench.program_spans import SYNC, prefixed


def read(trace):
    frames = trace.counts.get("frames")
    return len(prefixed(trace.host_annotations, SYNC)) / frames if frames else None
