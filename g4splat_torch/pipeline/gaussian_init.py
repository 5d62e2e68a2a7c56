"""Gaussian surfel initialization from per-view depth maps (counterpart of
`g4splat_tpu.pipeline.gaussian_init`).

1. `init_from_manifold_meshes`: each depth map becomes a pixel-grid manifold
   mesh (2 triangles per pixel quad); faces with an altitude ratio > 5 are
   dropped; one surfel per remaining face at its centroid, its two in-plane
   axes Gram-Schmidt-orthogonalized biggest first, quaternion from
   [axis1, axis2, normal], 2D scales 0.5 × the axes' norms; optionally one
   surfel per occupied voxel.
2. `init_by_warp_from_depths`: views in order, a surfel only for pixels no
   earlier view explains within 1 % relative depth under warping; scale half
   the nearest 4-neighbour distance, orientation from the local normal,
   scales ≥ 0.05 dropped, floored at 5e-4.

Everything runs on the depths' device and returns tensors there.
`scene_from_init` drops rows with a non-finite value first (a NaN splat is
inert in the renderer but never pruned).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, camera_at
from g4splat_torch.core.geometry import pixel_index
from g4splat_torch.core.transforms import normalize, rotmat_to_quat


# --------------------------------------------------------- manifold-mesh init
def manifold_mesh_from_points(points: torch.Tensor):
    """(H, W, 3) point map → (verts (H·W, 3), faces (2·(H-1)·(W-1), 3) int64)."""
    H, W, _ = points.shape
    idx = torch.arange(H * W, device=points.device).reshape(H, W)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, :-1].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    faces = torch.cat([torch.stack([a, c, b], 1), torch.stack([b, c, d], 1)], dim=0)
    return points.reshape(-1, 3), faces


def _altitude_ratio(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face max / min altitude."""
    fv = verts[faces]
    sides = torch.roll(fv, 1, dims=1) - fv
    ns = torch.roll(normalize(sides), -1, dims=1)
    alts = sides - torch.sum(sides * ns, dim=-1, keepdim=True) * ns
    al = torch.linalg.norm(alts, dim=-1)
    return torch.max(al, dim=1).values / torch.clamp(torch.min(al, dim=1).values, min=1e-12)


def surfels_from_mesh(verts: torch.Tensor, faces: torch.Tensor,
                      vert_colors: Optional[torch.Tensor] = None,
                      normalized_scales: float = 0.5) -> Dict[str, torch.Tensor]:
    """One surfel per face at its centroid: dict(means, scales (2),
    quaternions, colors)."""
    fv = verts[faces]
    means = fv.mean(dim=1)
    s2 = np.sqrt(2.0) / 2.0
    s6 = 1.0 / np.sqrt(6.0)
    shifts = torch.tensor([[-s2, s2, 0.0], [-s6, -s6, 2.0 / np.sqrt(6.0)]],
                          dtype=torch.float32, device=verts.device)
    axes = torch.einsum("kj,fjd->fkd", shifts, fv)
    n0 = torch.linalg.norm(axes, dim=-1)
    first_is_0 = (n0[:, 0] >= n0[:, 1])[:, None]
    a1 = torch.where(first_is_0, axes[:, 0], axes[:, 1])
    a2 = torch.where(first_is_0, axes[:, 1], axes[:, 0])
    a2 = a2 - torch.sum(a2 * a1, -1, keepdim=True) * a1 / torch.clamp(
        torch.sum(a1 * a1, -1, keepdim=True), min=1e-20)
    o1 = torch.where(first_is_0, a1, a2)
    o2 = torch.where(first_is_0, a2, a1)
    u1, u2 = normalize(o1), normalize(o2)
    R = torch.stack([u1, u2, torch.linalg.cross(u1, u2)], dim=-1)
    out = {"means": means, "scales": torch.stack(
               [torch.linalg.norm(o1, dim=-1), torch.linalg.norm(o2, dim=-1)], dim=-1)
               * normalized_scales,
           "quaternions": rotmat_to_quat(R)}
    if vert_colors is not None:
        out["colors"] = vert_colors[faces].mean(dim=1)
    return out


def voxel_downsample_indices(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """Index of the first point in each occupied voxel, ascending."""
    keys = torch.floor(points / voxel).to(torch.int64)
    _, inverse = torch.unique(keys, dim=0, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), points.shape[0], dtype=torch.int64,
                       device=points.device)
    first.scatter_reduce_(0, inverse, torch.arange(points.shape[0], device=points.device),
                          reduce="amin")
    return torch.sort(first).values


def init_from_manifold_meshes(cameras: Camera, depths: torch.Tensor, images: torch.Tensor,
                              visibility_masks: Optional[torch.Tensor] = None,
                              ratio_th: float = 5.0, normalized_scales: float = 0.5,
                              voxel_downsample: float = 0.0) -> Dict[str, torch.Tensor]:
    """Per-pixel manifold-mesh surfel init over every view, concatenated in
    view order. A pixel of depth ≤ 0 has no surface point, and its faces are
    dropped: at depth 0 all three vertices are the camera centre, a surfel of
    rounding-noise scale whose mip-filtered opacity has a NaN gradient on the
    card. The JAX package keeps them (ROADMAP C12)."""
    parts = {"means": [], "scales": [], "quaternions": [], "colors": []}
    for v in range(depths.shape[0]):
        verts, faces = manifold_mesh_from_points(camera_at(cameras, v).backproject(depths[v]))
        keep = ((_altitude_ratio(verts, faces) < ratio_th)
                & (depths[v].reshape(-1) > 0)[faces].all(dim=1))
        if visibility_masks is not None:
            keep &= visibility_masks[v].reshape(-1)[faces].all(dim=1)
        faces = faces[keep]
        if len(faces) == 0:
            continue
        out = surfels_from_mesh(verts, faces, vert_colors=images[v].reshape(-1, 3),
                                normalized_scales=normalized_scales)
        for k in parts:
            parts[k].append(out[k])
    parts = {k: torch.cat(vs, dim=0) for k, vs in parts.items()}
    if voxel_downsample > 0:
        idx = voxel_downsample_indices(parts["means"], voxel_downsample)
        parts = {k: v[idx] for k, v in parts.items()}
    return parts


# ------------------------------------------------------------ warp-dedup init
def _points_to_distance_map(points: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) → (H, W) distance to the nearest 4-neighbour."""
    dh = torch.linalg.norm(points[:, 1:] - points[:, :-1], dim=-1)
    dv = torch.linalg.norm(points[1:] - points[:-1], dim=-1)
    dr = torch.cat([dh, dh[:, -1:]], dim=1)
    dl = torch.cat([dh[:, :1], dh], dim=1)
    dd = torch.cat([dv, dv[-1:]], dim=0)
    du = torch.cat([dv[:1], dv], dim=0)
    return torch.minimum(torch.minimum(dr, dl), torch.minimum(dd, du))


def _points_to_normal_map(points: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) → (H, W, 3) central-difference normals, border replicated."""
    n = torch.zeros_like(points)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n[1:-1, 1:-1] = normalize(torch.linalg.cross(dx, dy))
    n[0] = n[1]
    n[-1] = n[-2]
    n[:, 0] = n[:, 1]
    n[:, -1] = n[:, -2]
    return n


def _normals_to_quaternions(normals: torch.Tensor) -> torch.Tensor:
    """(N, 3) → (N, 4) quaternions whose z axis is the normal."""
    z = normalize(normals)
    ex = torch.tensor([1.0, 0.0, 0.0], device=normals.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=normals.device)
    ref = torch.where((torch.abs(z[:, 0]) > 0.9)[:, None], ey, ex)
    x = normalize(torch.linalg.cross(ref.expand_as(z), z))
    y = torch.linalg.cross(z, x)
    return rotmat_to_quat(torch.stack([x, y, z], dim=-1))


def _warp_coverage(points_world, valid, cam: Camera, target_depth, thresh):
    """(H, W) bool: is each source point already explained by the target view?"""
    H, W = target_depth.shape
    w2c = cam.w2c
    pc = points_world @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[..., 2]
    u = pc[..., 0] / torch.clamp(z, min=1e-6) * cam.fx + cam.cx
    v = pc[..., 1] / torch.clamp(z, min=1e-6) * cam.fy + cam.cy
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0) & valid
    td = target_depth[pixel_index(torch.round(v), H - 1), pixel_index(torch.round(u), W - 1)]
    rel = torch.abs(z - td) / (torch.abs(z) + 1e-6)
    return in_img & (td > 0) & (rel < thresh)


def init_by_warp_from_depths(cameras: Camera, depths: torch.Tensor, images: torch.Tensor,
                             depth_error_thresh: float = 0.01, min_scale: float = 5e-4,
                             max_scale: float = 0.05,
                             downsample_pixel_grid_size: int = -1) -> Dict[str, torch.Tensor]:
    """Memory-saving dedup init over the views in order."""
    V, H, W = depths.shape
    parts = {"means": [], "scales": [], "quaternions": [], "colors": []}
    for v in range(V):
        pts = camera_at(cameras, v).backproject(depths[v])
        valid = depths[v] > 0
        covered = torch.zeros((H, W), dtype=torch.bool, device=depths.device)
        for prev in range(v):
            covered |= _warp_coverage(pts, valid, camera_at(cameras, prev), depths[prev],
                                      depth_error_thresh)
        keep = ~covered & valid
        g = downsample_pixel_grid_size
        if g > 0:
            grid = torch.zeros((H, W), dtype=torch.bool, device=depths.device)
            grid[::g, ::g] = True
            keep &= grid
        keep = keep.reshape(-1)
        if not bool(keep.any()):
            continue
        scale = _points_to_distance_map(pts).reshape(-1)[keep] / 2.0
        if g > 0:
            scale = scale * g
        parts["means"].append(pts.reshape(-1, 3)[keep])
        parts["scales"].append(scale[:, None].repeat(1, 2))
        parts["quaternions"].append(
            _normals_to_quaternions(_points_to_normal_map(pts).reshape(-1, 3)[keep]))
        parts["colors"].append(images[v].reshape(-1, 3)[keep])
    out = {k: torch.cat(vs, 0) for k, vs in parts.items()}
    ok = out["scales"][:, 0] < max_scale
    out = {k: v[ok] for k, v in out.items()}
    out["scales"] = torch.clamp(out["scales"], min=min_scale)
    return out


def scene_from_init(parts: Dict[str, torch.Tensor], capacity: Optional[int] = None,
                    max_sh_degree: int = 3, initial_opacity: float = 0.1):
    """Init dict → GaussianScene on the parts' device; non-finite rows are
    dropped first."""
    from g4splat_torch.models.gaussians import GaussianScene

    means = parts["means"]
    n = len(means)
    finite = torch.isfinite(means).all(dim=1)
    for k in ("scales", "quaternions", "colors"):
        if parts.get(k) is not None:
            finite &= torch.isfinite(parts[k]).reshape(n, -1).all(dim=1)
    if not bool(finite.all()):
        print(f"[gaussian_init] dropping {int((~finite).sum())} non-finite init points of {n}",
              flush=True)
        parts = {k: (v[finite] if getattr(v, "ndim", 0) >= 1 and len(v) == n else v)
                 for k, v in parts.items()}
    return GaussianScene.from_points(parts["means"], parts.get("colors"), capacity=capacity,
                                     max_sh_degree=max_sh_degree,
                                     initial_opacity=initial_opacity, scales=parts["scales"],
                                     quats=parts["quaternions"], device=means.device)
