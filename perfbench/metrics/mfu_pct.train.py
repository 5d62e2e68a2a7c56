"""The traced steps' operations (`counts.train_step.step_flops`) over the
traced window's time at the card's float32 peak."""
from perfbench.counts.peaks import FP32_FLOPS


def read(trace):
    flops, steps = trace.counts.get("step_flops"), trace.counts.get("steps")
    if not flops or not steps or trace.window_s <= 0:
        return None
    return 100.0 * steps * flops / (trace.window_s * FP32_FLOPS)
