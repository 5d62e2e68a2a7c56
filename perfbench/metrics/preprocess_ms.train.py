"""Host milliseconds per training step of render()'s preprocess (the
`g4s:render.preprocess` span: projection, SH, the splat fields)."""
from perfbench.program_spans import STEP, per


def read(trace):
    return per(trace.host_annotations, "g4s:render.preprocess", STEP)
