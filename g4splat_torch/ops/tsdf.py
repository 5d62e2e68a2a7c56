"""Adaptive TSDF evaluation at arbitrary query points (counterpart of
`g4splat_tpu.ops.tsdf`).

The reference's AdaptiveTSDF (matcha/dm_extractors/adaptive_tsdf.py:115-345)
evaluates the truncated signed distance at arbitrary points (tetrahedra
vertices, binary-search midpoints) by projecting them into every rendered
depth map and fusing the per-view observations. The JAX package runs the
views as one `lax.scan`; here they are a loop of PyTorch tensor ops over the
views, on the maps' device, with points streamed in chunks. No Pallas kernel
stands behind it in the JAX package, and none is written here.

Semantics kept: bilinear depth sampling with the gradient-aware fallback to
nearest (:270-283), frustum + znear/zfar validity with `px <= W-1` (:247-252),
the optional depth-gradient and normal-consistency filters (:255-264), read
before the sampling branch; sdf = min(Δ/trunc, 1) with discard below −trunc
(:288-296), optional unbiasing by |ray·normal| (:290-297), the weighted
running mean (min() in binary-opacity mode) and colour mean (:313-339),
softmax and normal-consistency weights (:299-306), unobserved points left at
−1 (+1 in binary mode), and the final 0.5 − v flip in binary mode (:341-345).
Rounding to the nearest pixel is half to even, as `jnp.round`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from g4splat_torch.core.cameras import Camera, project_points
from g4splat_torch.core.geometry import bilinear_sample, depth_to_normal, pixel_index


@dataclass(frozen=True)
class TSDFConfig:
    trunc_margin: float = 0.05
    znear: float = 1e-6
    zfar: float = 1e6
    use_binary_opacity: bool = False
    interpolate_depth: bool = True
    weight_interpolation_by_depth_gradient: bool = False
    depth_gradient_threshold: float = 1.0
    filter_with_depth_gradient: bool = False
    depth_gradient_threshold_for_filtering: float = 1.0
    unbias_depth_using_normals: bool = False
    weight_by_softmax: bool = False
    softmax_temperature: float = 1.0
    # 'bilinear' | 'nearest': sampling when interpolate_depth is on.
    interpolation_mode: str = "bilinear"
    # Drop observations whose rendered-vs-surface normal agreement
    # (reference_normals · normals) is at most the threshold (:257-264),
    # and/or weight them by |agreement| (:305-306).
    filter_with_normal_consistency: bool = False
    normal_consistency_threshold: float = 0.5
    weight_by_normal_consistency: bool = False


class TSDFOut(NamedTuple):
    tsdf: torch.Tensor     # (N,)
    colors: torch.Tensor   # (N, 3)
    weights: torch.Tensor  # (N,)


def _depth_gradient(depth: torch.Tensor) -> torch.Tensor:
    """Replicate-padded central-difference magnitude (reference :215-221)."""
    p = F.pad(depth[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = p[2:, 1:-1] - p[:-2, 1:-1]
    gy = p[1:-1, 2:] - p[1:-1, :-2]
    return torch.sqrt(gx * gx + gy * gy)


def integrate_views(
    points: torch.Tensor,              # (N, 3)
    cameras: Camera,                   # batched (V, …)
    images: torch.Tensor,              # (V, H, W, 3)
    depths: torch.Tensor,              # (V, H, W)
    cfg: TSDFConfig,
    normals: Optional[torch.Tensor] = None,            # (V, H, W, 3) surface
    reference_normals: Optional[torch.Tensor] = None,  # (V, H, W, 3) rendered
) -> TSDFOut:
    """Fuse every view's observation of `points`, on the maps' device."""
    N = points.shape[0]
    V, H, W = depths.shape
    dev = depths.device
    points = points.to(dev)
    tsdf = torch.full((N,), 1.0 if cfg.use_binary_opacity else -1.0, device=dev)
    weights = torch.zeros(N, device=dev)
    colors = torch.zeros((N, 3), device=dev)
    need_nc = cfg.filter_with_normal_consistency or cfg.weight_by_normal_consistency
    bilinear = cfg.interpolate_depth and cfg.interpolation_mode != "nearest"
    need_grad = cfg.filter_with_depth_gradient or (
        bilinear and cfg.weight_interpolation_by_depth_gradient)
    nrm_all = normals if normals is not None else torch.zeros_like(images)
    ref_all = reference_normals if reference_normals is not None else torch.zeros_like(images)
    world2pix = cameras.world2pix                       # (V, 3, 4)
    centers = cameras.center                            # (V, 3)

    for v in range(V):
        img, depth, nrm = images[v], depths[v], nrm_all[v]
        xy, z = project_points(world2pix[v], points)
        px, py = xy[:, 0], xy[:, 1]
        ix = pixel_index(torch.round(px), W - 1)
        iy = pixel_index(torch.round(py), H - 1)
        valid = ((px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
                 & (z > cfg.znear) & (z < cfg.zfar))

        grad = _depth_gradient(depth) if need_grad else None
        if cfg.filter_with_depth_gradient:
            valid = valid & (grad[iy, ix] < cfg.depth_gradient_threshold_for_filtering)
        if need_nc:
            nc = torch.sum(ref_all[v] * nrm, dim=-1)[iy, ix]
            if cfg.filter_with_normal_consistency:
                valid = valid & (nc > cfg.normal_consistency_threshold)

        if bilinear:
            d_at = bilinear_sample(depth, xy)
            if cfg.weight_interpolation_by_depth_gradient:
                d_at = torch.where(grad[iy, ix] > cfg.depth_gradient_threshold,
                                   depth[iy, ix], d_at)
        else:
            d_at = depth[iy, ix]

        diff = d_at - z
        valid = valid & (d_at > 0) & (diff >= -cfg.trunc_margin)
        if cfg.unbias_depth_using_normals and normals is not None:
            rays = points - centers[v]
            rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + 1e-12)
            diff = diff * torch.abs(torch.sum(rays * nrm[iy, ix], dim=-1))
        dist = torch.clamp(diff / cfg.trunc_margin, max=1.0)

        w = torch.ones(N, device=dev)
        if cfg.weight_by_softmax:
            w = w * torch.exp(cfg.softmax_temperature * dist)
        if cfg.weight_by_normal_consistency:
            w = w * torch.abs(nc)
        w = torch.where(valid, w, 0.0)

        new_weights = weights + w
        safe = torch.clamp(new_weights, min=1e-12)
        if cfg.use_binary_opacity:
            opacity = (dist < 0.0).to(torch.float32)
            tsdf = torch.where(valid, torch.minimum(tsdf, opacity), tsdf)
        else:
            tsdf = torch.where(valid, (tsdf * weights + dist * w) / safe, tsdf)
        img_at = bilinear_sample(img, xy) if bilinear else img[iy, ix]
        colors = torch.where(
            valid[:, None],
            torch.clamp((colors * weights[:, None] + img_at * w[:, None]) / safe[:, None],
                        0.0, 1.0),
            colors)
        weights = new_weights
    if cfg.use_binary_opacity:
        tsdf = 0.5 - tsdf
    return TSDFOut(tsdf, colors, weights)


def apply_sdf_tolerance(depth: torch.Tensor, focal, tolerance_px: float = 1.5,
                        max_tolerance: float = 0.01) -> torch.Tensor:
    """Shrink depths by a pixel-scaled tolerance so the TSDF zero crossing
    sits slightly in front of the rendered surface
    (extract_mesh_adaptive_tsdf.py:175-184): depth − min(tol_px / focal ·
    depth, max_tolerance). `focal` broadcasts against `depth`."""
    return depth - torch.clamp(tolerance_px / focal * depth, max=max_tolerance)


def dilate_depth_along_normals(cam: Camera, depth: torch.Tensor, rgb: torch.Tensor,
                               dilation_px: float = 1.5, max_dilation: float = 0.01):
    """Depth/RGB dilation (extract_mesh_adaptive_tsdf.py:49-137) as the JAX
    package does it: backproject the depth map, move each point along its
    depth-derived normal by min(dilation_px / focal · depth, max_dilation),
    and z-buffer the moved points at their new pixels (scatter-min of depth;
    the colour of the point whose z equals the pixel's minimum, the largest
    such colour per channel on exact ties). Pixels no moved point lands on
    keep their values."""
    H, W = depth.shape
    pts = cam.backproject(depth)
    nrm = depth_to_normal(cam, depth)
    focal = (cam.fx + cam.fy) / 2.0
    fac = torch.clamp(dilation_px / focal * depth, max=max_dilation)[..., None]
    moved = (pts + fac * nrm).reshape(-1, 3)
    xy, z = cam.project(moved)
    ix = pixel_index(torch.round(xy[:, 0]), W - 1)
    iy = pixel_index(torch.round(xy[:, 1]), H - 1)
    ok = ((xy[:, 0] >= -0.5) & (xy[:, 0] <= W - 0.5)
          & (xy[:, 1] >= -0.5) & (xy[:, 1] <= H - 0.5)
          & (z > 1e-6) & (depth.reshape(-1) > 0))
    flat = iy * W + ix
    big = 1e10
    zb = torch.full((H * W,), big, device=depth.device).scatter_reduce(
        0, torch.where(ok, flat, 0), torch.where(ok, z, big), "amin", include_self=True)
    win = zb[flat] == z
    vals = torch.where((ok & win)[:, None], rgb.reshape(-1, 3), 0.0)
    cb = torch.zeros((H * W, 3), device=depth.device).scatter_reduce(
        0, flat[:, None].expand(-1, 3), vals, "amax", include_self=True)
    hit = zb < big
    new_depth = torch.where(hit.reshape(H, W), zb.reshape(H, W), depth)
    new_rgb = torch.where(hit.reshape(H, W, 1), cb.reshape(H, W, 3), rgb)
    return new_depth, new_rgb


def integrate_views_chunked(points, cameras: Camera, images: torch.Tensor,
                            depths: torch.Tensor, cfg: TSDFConfig, normals=None,
                            reference_normals=None, chunk: int = 262_144) -> TSDFOut:
    """`integrate_views` over `chunk` points at a time. `points` is an (N, 3)
    array or tensor; the result lies on the maps' device."""
    pts = torch.as_tensor(np.asarray(points, np.float32) if not torch.is_tensor(points)
                          else points, dtype=torch.float32, device=depths.device)
    outs = [integrate_views(pts[s:s + chunk], cameras, images, depths, cfg, normals,
                            reference_normals)
            for s in range(0, pts.shape[0], chunk)]
    if not outs:
        return integrate_views(pts, cameras, images, depths, cfg, normals,
                               reference_normals)
    return TSDFOut(*(torch.cat(parts) for parts in zip(*outs)))
