"""Milliseconds of the global blocks' attention cores per encoder call on the
device's timeline: the program's `g4s:sam.attn.global` spans (logits, both
rel-pos terms, softmax, the product with v) summed over the traced set,
over its `g4s:sam.encode` spans."""
from perfbench.program_spans import per


def read(trace):
    return per(trace.annotations, "g4s:sam.attn.global", "g4s:sam.encode")
