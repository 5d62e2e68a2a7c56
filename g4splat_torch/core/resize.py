"""Image resizing as ``jax.image.resize`` does it.

``jax.image.resize(..., "bilinear")`` samples at half-pixel centres and,
when it shrinks an axis, widens its triangle kernel by the scale factor
(antialiasing). ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`` computes the same weights, growing and shrinking alike.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the two spatial axes of (H, W, C) or (B, H, W, C) images to
    ``size`` = (h, w)."""
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
    y = (x if x.ndim == 4 else x[None]).permute(0, 3, 1, 2).to(torch.float32)
    y = F.interpolate(y, size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=True).permute(0, 2, 3, 1)
    return y if x.ndim == 4 else y[0]
