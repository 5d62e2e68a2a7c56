"""Depth/point/normal geometry ops (counterpart of `g4splat_tpu.core.geometry`)."""

from __future__ import annotations

import torch

from g4splat_torch.core.cameras import Camera
from g4splat_torch.core.transforms import normalize


def depth_to_normal(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth → (H, W, 3) world normals via central differences of the
    backprojected point map (reference point_utils.py:26-39), zero on the
    1-pixel border."""
    pts = cam.backproject(depth)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]   # d/d_row
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]   # d/d_col
    n = normalize(torch.linalg.cross(dx, dy))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
