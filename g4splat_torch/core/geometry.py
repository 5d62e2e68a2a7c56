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


def points_to_depth(cam: Camera, pts_world: torch.Tensor) -> torch.Tensor:
    """(…, 3) world points → view-z depths under `cam`."""
    R, t = cam.w2c[:3, :3], cam.w2c[:3, 3]
    return pts_world @ R[2] + t[2]


def pixel_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """Float pixel coordinates → int64 indices clamped to [0, hi]; NaN goes
    to 0 (as XLA converts it), so a gather never leaves the image."""
    return torch.nan_to_num(torch.clamp(v, 0, hi), nan=0.0).to(torch.int64)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W[, C]) image at float pixel coords xy (…, 2) (x = column,
    y = row) → (…[, C]). Coordinates clamp to the border; the left/top texel
    clamps to W-2 / H-2, so the last column and row interpolate with
    weight 1."""
    H, W = img.shape[0], img.shape[1]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = pixel_index(torch.floor(x), W - 2)
    y0 = pixel_index(torch.floor(y), H - 2)
    wx = x - x0
    wy = y - y0
    if img.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    return (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x0 + 1] * wx * (1 - wy)
            + img[y0 + 1, x0] * (1 - wx) * wy + img[y0 + 1, x0 + 1] * wx * wy)
