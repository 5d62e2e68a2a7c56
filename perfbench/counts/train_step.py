"""Floating-point operations of one 2DGS training step, from its sizes:
the denominator-free numerator of `mfu_pct.train`.

Per live splat: the projection forward (quaternion to matrix 30, T = M·S
72, the conic centre and radius 40, the view normal 20, degree-3 SH colour
about 130: 292) and its backward (twice that: 584). Per pixel and channel
of the losses: the SSIM's five separable 11-tap blurs (5 × 2 × 22) and its
map (about 30), the L1 and the prior and order terms (about 40), taken
three times for the backward. Adam: 12 operations a parameter of a live
splat (59 parameters). The rasterizer's pairs as in `raster`.
"""

from __future__ import annotations

from perfbench.counts.raster import b1_work, b2_work

SPLAT_FWD_OPS = 292
SPLAT_BWD_OPS = 584
PIXEL_LOSS_OPS = 3 * (3 * (5 * 2 * 22 + 30) + 40)
ADAM_OPS = 12
PARAMS_PER_SPLAT = 59


def step_flops(pairs: int, live: int, entries: int, width: int, height: int,
               dist: bool) -> float:
    fwd, _ = b1_work(pairs, live, entries, width, height, dist)
    bwd, _ = b2_work(pairs, live, entries, width, height, dist)
    return (fwd + bwd + live * (SPLAT_FWD_OPS + SPLAT_BWD_OPS)
            + width * height * PIXEL_LOSS_OPS + live * PARAMS_PER_SPLAT * ADAM_OPS)
