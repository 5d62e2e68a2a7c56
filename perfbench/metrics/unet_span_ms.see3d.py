"""Milliseconds of one MV-UNet call on the device's timeline (the
`g4s:see3d.unet` span of `See3DPipeline._denoise`): the program's own
counterpart of `unet_call_ms.see3d`."""
from perfbench.program_spans import mean


def read(trace):
    return mean(trace.annotations, "g4s:see3d.unet")
