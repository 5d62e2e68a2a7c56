"""The attention layer's share of its roofline: the least time of the
traced set's attention cores (`counts.sam.attention_least_s`: both products
and the rel-pos terms of every windowed and global block, against dense
TF32) over the device time inside the program's `g4s:sam.attn.window` and
`g4s:sam.attn.global` spans. It reads the layer by its work and its spans,
whatever kernels implement it."""
from perfbench.program_spans import prefixed


def read(trace):
    least = trace.counts.get("attn_least_s")
    ms = sum(prefixed(trace.annotations, "g4s:sam.attn."))
    if not least or not ms:
        return None
    return 100.0 * least / (ms / 1e3)
