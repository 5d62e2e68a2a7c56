"""Share of `render()`'s preprocess calls that ran the preprocess kernels
(`csrc/preprocess.cu`), in %: 100 × `render.preprocesses_kernel` over
`render.preprocesses`, the program's counters, kept at one site. None where the
program has no `render.preprocesses_kernel` counter (a tree without the kernels)."""


def read(trace):
    try:
        from g4splat_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    calls = c.get("render.preprocesses")
    kernel = c.get("render.preprocesses_kernel")
    return 100.0 * kernel / calls if calls and kernel is not None else None
