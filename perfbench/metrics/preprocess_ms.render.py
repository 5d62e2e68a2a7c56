"""Host milliseconds of one render()'s preprocess in the viewer's frames
(the `g4s:render.preprocess` span: projection, SH, the splat fields)."""
from perfbench.program_spans import mean


def read(trace):
    return mean(trace.host_annotations, "g4s:render.preprocess")
