"""Host milliseconds per training step of `zero_grad` and `loss.backward()`
(the `g4s:train.backward` span): B2 and the autograd of preprocess, SH and
postprocess, as far as the host waits for them or launches them."""
from perfbench.program_spans import STEP, per


def read(trace):
    return per(trace.host_annotations, "g4s:train.backward", STEP)
