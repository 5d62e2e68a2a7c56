"""Share of `bin_splats` calls that ran the binning kernel chain
(`csrc/binning.cu`), in %: 100 × `render.binnings_kernel` over
`render.binnings`, the program's counters, kept at one site. None where the
program has no `render.binnings_kernel` counter (a tree without the chain)."""


def read(trace):
    try:
        from g4splat_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    calls = c.get("render.binnings")
    kernel = c.get("render.binnings_kernel")
    return 100.0 * kernel / calls if calls and kernel is not None else None
