"""Novel-view proposal and selection for generative inpainting (counterpart
of `g4splat_tpu.pipeline.novel_views`).

- `VisibilityGrid`: a voxel grid marking the space some input view observes
  (voxel centres projecting inside an input frustum in front of, or near,
  its depth map); proposals must sit in observed space. The grid is built
  on the cameras' device, view by view, and kept on the host for lookups.
- Proposals per stage: 1 an object-centric ring, 2 look-around rotations at
  the input positions, 3 wide-FOV cameras facing the fitted planes. Eyes
  and targets are host numpy, as in the JAX package; cameras are built on
  the input cameras' device.
- `none_visible_rate_from_alpha` and `select_need_inpaint_views`: the
  shuffled greedy selection of candidates whose uncovered share lies in
  [lo, hi] and whose splat covisibility with the views already kept stays
  ≤ 0.8, with two relaxations; `random.Random(seed)` shuffles exactly as the
  JAX package does, so the same rates give the same ids.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, camera_at, lookat_camera, stack_cameras
from g4splat_torch.core.geometry import pixel_index


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------ visibility grid
class VisibilityGrid:
    def __init__(self, bbox_min, bbox_max, resolution: int, input_cameras: Camera,
                 input_depths: torch.Tensor):
        self.bbox_min = np.array(_host(bbox_min), np.float32)
        self.bbox_max = np.array(_host(bbox_max), np.float32)
        # Degenerate (e.g. planar-scene) extents would zero grid_size and NaN
        # every index: inflate them to a minimal slab.
        thin = self.bbox_max - self.bbox_min < 1e-6
        pad = np.where(thin, 0.5 * max(1e-3, float(
            (self.bbox_max - self.bbox_min).max())), 0.0).astype(np.float32)
        self.bbox_min -= pad
        self.bbox_max += pad
        self.resolution = resolution
        self.grid_size = (self.bbox_max - self.bbox_min) / resolution

        dev = input_depths.device
        r = resolution
        axes = [torch.as_tensor(float(self.bbox_min[i]), dtype=torch.float64, device=dev)
                + (torch.arange(r, dtype=torch.float64, device=dev) + 0.5)
                * float(self.grid_size[i]) for i in range(3)]
        centers = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        valid = check_visible_from_depths(input_cameras, input_depths,
                                          centers.to(torch.float32))
        self.grid = valid.reshape(r, r, r).cpu().numpy()

    def is_visible(self, points) -> np.ndarray:
        """(N, 3) world points → bool mask (outside the box = invisible)."""
        idx = np.floor((np.asarray(points) - self.bbox_min) / self.grid_size).astype(np.int64)
        inside = ((idx >= 0) & (idx < self.resolution)).all(axis=-1)
        idx = np.clip(idx, 0, self.resolution - 1)
        return inside & self.grid[idx[:, 0], idx[:, 1], idx[:, 2]]


def check_visible_from_depths(cameras: Camera, depths: torch.Tensor,
                              points: torch.Tensor) -> torch.Tensor:
    """A point is visible when some view sees it in front of (or within 2 %
    behind) its depth surface."""
    H, W = depths.shape[1:]
    vis = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for v in range(depths.shape[0]):
        xy, z = camera_at(cameras, v).project(points)
        u = pixel_index(torch.round(xy[:, 0]), W - 1)
        vv = pixel_index(torch.round(xy[:, 1]), H - 1)
        in_img = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & (xy[:, 1] >= 0)
                  & (xy[:, 1] <= H - 1) & (z > 0))
        d = depths[v][vv, u]
        vis |= in_img & (d > 0) & (z < d * 1.02)
    return vis


# ----------------------------------------------------------------- proposals
@dataclass
class ProposalConfig:
    n_frames: int = 60
    width: int = 512
    height: int = 512
    fov_deg: float = 60.0
    stage3_fov_deg: float = 100.0


def _fov_to_focal(fov_deg: float, pixels: int) -> float:
    return pixels / (2.0 * np.tan(np.radians(fov_deg) / 2.0))


def _cameras(cams: List[Camera]) -> Optional[Camera]:
    return stack_cameras(cams) if cams else None


def propose_object_centric(input_cameras: Camera, grid: Optional[VisibilityGrid],
                           traj_center=None, cfg: ProposalConfig = ProposalConfig()
                           ) -> Optional[Camera]:
    """Stage 1: a ring around the scene centre at the input cameras' mean
    radius, keeping the eyes in observed space (else the input centres that
    are; None if none is)."""
    centers = _host(input_cameras.center)
    target = traj_center if traj_center is not None else centers.mean(0)
    radius = np.linalg.norm(centers - target, axis=1).mean()
    up = np.array([0.0, -1.0, 0.0])
    f = _fov_to_focal(cfg.fov_deg, cfg.height)
    eyes = []
    for k in range(cfg.n_frames):
        a = 2 * np.pi * k / cfg.n_frames
        elev = 0.25 * np.sin(2 * a)
        eyes.append(target + radius * np.array(
            [np.cos(a) * np.cos(elev), np.sin(elev), np.sin(a) * np.cos(elev)]))
    eyes = np.stack(eyes)
    if grid is not None:
        eyes = eyes[grid.is_visible(eyes)]
        if len(eyes) == 0:
            eyes = centers[grid.is_visible(centers)]
    return _cameras([lookat_camera(eye, target, up, fx=f, fy=f, width=cfg.width,
                                   height=cfg.height, device=input_cameras.device)
                     for eye in eyes])


def propose_look_around(input_cameras: Camera, cfg: ProposalConfig = ProposalConfig(),
                        yaw_range: float = np.pi / 2, n_per_view: int = 12) -> Camera:
    """Stage 2: rotations in place at each input camera position."""
    V = input_cameras.w2c.shape[0]
    f = _fov_to_focal(cfg.fov_deg, cfg.height)
    c2ws = _host(input_cameras.c2w)
    cams = []
    for v in range(V):
        c2w = c2ws[v]
        eye, fwd, up, right = c2w[:3, 3], c2w[:3, 2], -c2w[:3, 1], c2w[:3, 0]
        for k in range(n_per_view):
            yaw = -yaw_range / 2 + yaw_range * k / max(n_per_view - 1, 1)
            d = np.cos(yaw) * fwd + np.sin(yaw) * right
            cams.append(lookat_camera(eye, eye + d, -up, fx=f, fy=f, width=cfg.width,
                                      height=cfg.height, device=input_cameras.device))
    return stack_cameras(cams)


def propose_plane_targeted(input_cameras: Camera, plane_centers, plane_normals,
                           grid: Optional[VisibilityGrid] = None,
                           cfg: ProposalConfig = ProposalConfig(),
                           standoff: float = 1.5) -> Optional[Camera]:
    """Stage 3: wide-FOV cameras on each plane's normal (on the cameras'
    side), looking at its centre."""
    f = _fov_to_focal(cfg.stage3_fov_deg, cfg.height)
    up = np.array([0.0, -1.0, 0.0])
    mean_center = _host(input_cameras.center).mean(0)
    cams = []
    for c, n in zip(plane_centers, plane_normals):
        n = n / (np.linalg.norm(n) + 1e-12)
        if np.dot(mean_center - c, n) < 0:
            n = -n
        eye = c + standoff * n
        if grid is not None and not grid.is_visible(eye[None])[0]:
            eye = 0.5 * (eye + mean_center)
        if np.linalg.norm(np.cross(c - eye, up)) < 1e-6:
            up = np.array([0.0, 0.0, 1.0])
        cams.append(lookat_camera(eye, c, up, fx=f, fy=f, width=cfg.width,
                                  height=cfg.height, device=input_cameras.device))
    return _cameras(cams)


# ------------------------------------------------------------------ selection
def visible_points_mask(camera: Camera, points: torch.Tensor,
                        znear: float = 0.01) -> torch.Tensor:
    """Frustum test of world points."""
    xy, z = camera.project(points)
    W, H = camera.width, camera.height
    return ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & (xy[:, 1] >= 0)
            & (xy[:, 1] <= H - 1) & (z > znear))


def covisibility_by_splats(cam1: Camera, cam2: Camera, xyz: torch.Tensor) -> float:
    """max over the two directions of |visible in both| / |visible in one|."""
    return _covisibility(visible_points_mask(cam1, xyz), visible_points_mask(cam2, xyz))


def _covisibility(m1: torch.Tensor, m2: torch.Tensor) -> float:
    common, n1, n2 = (int(x) for x in torch.stack([(m1 & m2).sum(), m1.sum(), m2.sum()]))
    r1 = common / n1 if n1 > 0 else 0.0
    r2 = common / n2 if n2 > 0 else 0.0
    return max(r1, r2)


def none_visible_rate_from_alpha(alpha, thresh: float = 0.5) -> float:
    """Share of a candidate render the current model leaves uncovered."""
    if torch.is_tensor(alpha):
        return int((alpha < thresh).sum()) / alpha.numel()
    return float((np.asarray(alpha) < thresh).mean())


def select_need_inpaint_views(candidate_cameras: Camera, none_visible_rates: Sequence[float],
                              splat_xyz: torch.Tensor, select_num: int = 10,
                              low_bound: float = 0.05, high_bound: float = 0.5,
                              covisible_high_bound: float = 0.8, seed: int = 0) -> List[int]:
    """Greedy diverse selection; each candidate's frustum mask over the
    splats is computed once, on the splats' device."""
    rng = random.Random(seed)
    N = len(none_visible_rates)
    masks: Dict[int, torch.Tensor] = {}

    def mask(i):
        if i not in masks:
            masks[i] = visible_points_mask(camera_at(candidate_cameras, i), splat_xyz)
        return masks[i]

    view_rates = list(enumerate(none_visible_rates))
    rng.shuffle(view_rates)
    filtered = [(i, r) for i, r in view_rates if low_bound <= r <= high_bound]
    selected: List[int] = []
    if filtered:
        selected.append(filtered[0][0])

    def try_add(pool):
        for vid, _ in pool:
            if vid in selected:
                continue
            if any(_covisibility(mask(s), mask(vid)) > covisible_high_bound for s in selected):
                continue
            selected.append(vid)
            if len(selected) >= select_num:
                return True
        return False

    if not try_add(filtered) and len(selected) < select_num:
        try_add([(i, r) for i, r in view_rates if r < low_bound and i not in selected])
    if len(selected) < select_num:
        remaining = [i for i in range(N)
                     if i not in selected and none_visible_rates[i] <= high_bound]
        rng.shuffle(remaining)
        selected.extend(remaining[: select_num - len(selected)])
    return selected
