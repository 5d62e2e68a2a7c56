"""Gigabytes of N × N attention logits the encoder materialises per view,
from the program's counters `sam.attn_logit_bytes` and `sam.images`, which
count at the attention core and the encoder's entry over every stretch a
profiler recorded."""


def read(trace):
    try:
        from g4splat_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    views, nbytes = c.get("sam.images"), c.get("sam.attn_logit_bytes")
    return nbytes / views / 1e9 if views and nbytes else None
