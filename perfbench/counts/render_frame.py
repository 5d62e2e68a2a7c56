"""Floating-point operations of one inference frame of `render()` (no
autograd, no distortion channel), from its sizes: the numerator of
`mfu_pct.render`.

Per live splat, the projection forward as a training step counts it
(`train_step.SPLAT_FWD_OPS`: quaternion to matrix, T = M·S, the conic
centre and radius, the view normal, degree-3 SH colour). The rasterizer's
pairs as in `raster.b1_work` without distortion. Per pixel the post-
processing (90): the normal to world 15, the expected depth and the surface
depth 5, the normal from depth (the ray 4, the back-projection 21, the two
differences 6, the cross product 9, the normalisation 9, × alpha 3) 52,
and its rotation back to the camera 15, rounded up by 3 for the clamps.
"""

from __future__ import annotations

from perfbench.counts.raster import b1_work
from perfbench.counts.train_step import SPLAT_FWD_OPS

PIXEL_POST_OPS = 90


def frame_flops(pairs: int, live: int, entries: int, width: int, height: int) -> float:
    ops, _ = b1_work(pairs, live, entries, width, height, False)
    return float(ops + live * SPLAT_FWD_OPS + width * height * PIXEL_POST_OPS)
