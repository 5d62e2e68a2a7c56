"""Millions of (splat, tile) entries per `bin_splats` call, from the
program's counters `render.binned_entries` and `render.binnings`, which
count at one site over every stretch a profiler recorded."""


def read(trace):
    try:
        from g4splat_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    calls = c.get("render.binnings")
    return c["render.binned_entries"] / calls / 1e6 if calls else None
