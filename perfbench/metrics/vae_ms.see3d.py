"""Device milliseconds of the VAE's encode and decode per inpaint call."""


def read(trace):
    v, calls = trace.spans.get("vae"), trace.counts.get("inpaint_calls")
    if not v or not calls:
        return None
    return sum(v) / calls
