"""The traced call's operations (the plain reference's UNet, VAE and CLIP
work counted by FlopCounterMode at the cell's shapes, attention as
4·B·H·N·M·D) over the traced window's time at the card's dense TF32 peak."""
from perfbench.counts.peaks import TF32_FLOPS


def read(trace):
    flops = trace.counts.get("window_flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * TF32_FLOPS)
