"""Gaussian surfel scene state (counterpart of `g4splat_tpu.models.gaussians`).

As in the JAX package the scene is a fixed-capacity buffer of surfels with an
`alive` mask: dead slots carry zero opacity, so every consumer can ignore them
without special cases, and densify can later be compared slot by slot.

2DGS surfels: 2 tangent scales (log-space), wxyz quaternion, SH color
(degree ≤ 3), scalar opacity (logit-space), optional per-splat mip (low-pass)
filter scale in world units (reference gaussian_model.py:388-434).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from g4splat_torch.core import sh as sh_lib
from g4splat_torch.core.transforms import normalize, quat_to_rotmat
from g4splat_torch.device import DeviceLike, resolve_device

_TENSOR_FIELDS = ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw",
                  "rotation_raw", "alive", "mip_filter")


def per_cam(xyz: torch.Tensor, cameras, znear: float = 0.2):
    """Each camera's view of the points for the mip filter: (V, N) view depth
    where the point lies in front of `znear` and within 15 % of the image
    beyond its borders (inf elsewhere), and that mask. `cameras` is a
    batched Camera."""
    w2c = cameras.w2c                                            # (V, 4, 4)
    p_cam = torch.einsum("vij,nj->vni", w2c[:, :3, :3], xyz) + w2c[:, None, :3, 3]
    z = torch.clamp(p_cam[..., 2], min=1e-3)                     # (V, N)
    width, height = float(cameras.width), float(cameras.height)
    x = p_cam[..., 0] / z * cameras.fx[:, None] + width / 2.0
    y = p_cam[..., 1] / z * cameras.fy[:, None] + height / 2.0
    in_screen = ((x >= -0.15 * width) & (x <= 1.15 * width)
                 & (y >= -0.15 * height) & (y <= 1.15 * height))
    valid = (p_cam[..., 2] > znear) & in_screen
    return torch.where(valid, z, torch.inf), valid


@dataclass(frozen=True)
class GaussianScene:
    xyz: torch.Tensor            # (N, 3) world positions
    f_dc: torch.Tensor           # (N, 1, 3) SH degree-0 coeffs
    f_rest: torch.Tensor         # (N, K-1, 3) higher SH coeffs
    opacity_raw: torch.Tensor    # (N, 1) logit opacity
    scaling_raw: torch.Tensor    # (N, 2) log tangent scales
    rotation_raw: torch.Tensor   # (N, 4) unnormalized wxyz quats
    alive: torch.Tensor          # (N,) bool
    mip_filter: torch.Tensor     # (N, 1) world-space low-pass scale (0 = off)
    max_sh_degree: int = 3
    active_sh_degree: int = 0
    use_mip_filter: bool = False

    def replace(self, **kw) -> "GaussianScene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GaussianScene":
        return self.replace(**{k: getattr(self, k).to(device) for k in _TENSOR_FIELDS})

    def tensors(self):
        return [getattr(self, k) for k in _TENSOR_FIELDS]

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def scaling(self) -> torch.Tensor:
        """(N, 2) activated tangent scales; the mip filter adds its variance
        (gaussian_model.py:158-163)."""
        s = torch.exp(self.scaling_raw)
        if self.use_mip_filter:
            s = torch.sqrt(s * s + self.mip_filter * self.mip_filter)
        return s

    def opacity(self) -> torch.Tensor:
        """(N, 1) activated opacity, mip-compensated (gaussian_model.py:180-192)
        and zeroed on dead slots."""
        o = torch.sigmoid(self.opacity_raw)
        if self.use_mip_filter:
            s2 = torch.exp(2.0 * self.scaling_raw)
            det1 = torch.prod(s2, dim=1)
            det2 = torch.prod(s2 + self.mip_filter * self.mip_filter, dim=1)
            o = o * torch.sqrt(det1 / torch.clamp(det2, min=1e-30))[..., None]
        return o * self.alive[..., None]

    def rotation(self) -> torch.Tensor:
        """(N, 4) unit wxyz quaternions."""
        return normalize(self.rotation_raw)

    def rotmats(self) -> torch.Tensor:
        """(N, 3, 3); columns 0, 1 are the tangent axes, column 2 the normal."""
        return quat_to_rotmat(self.rotation_raw)

    def features(self) -> torch.Tensor:
        """(N, K, 3) concatenated SH coefficients."""
        return torch.cat([self.f_dc, self.f_rest], dim=1)

    def normals(self) -> torch.Tensor:
        """(N, 3) world normals (the rotation's third column)."""
        return self.rotmats()[..., :, 2]

    def colors(self, camera_center: torch.Tensor) -> torch.Tensor:
        """(N, 3) view-dependent RGB from the active SH degree."""
        dirs = normalize(self.xyz - camera_center)
        return sh_lib.sh_to_rgb(self.active_sh_degree, self.features(), dirs)

    # --------------------------------------------------------------- editing
    def one_up_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            return self.replace(active_sh_degree=self.active_sh_degree + 1)
        return self

    def reset_opacity(self, ceiling: float = 0.01) -> "GaussianScene":
        """Clamp activated opacity to `ceiling` (gaussian_model.py:436-439)."""
        o = torch.clamp(torch.clamp(torch.sigmoid(self.opacity_raw), max=ceiling),
                        1e-6, 1.0 - 1e-6)
        return self.replace(opacity_raw=torch.log(o) - torch.log1p(-o))

    def compute_mip_filter(self, cameras, znear: float = 0.2,
                           filter_variance: float = 0.2) -> "GaussianScene":
        """Per-splat screen-space low-pass scale: min view depth / max focal ×
        sqrt(filter_variance) over all cameras seeing the splat
        (gaussian_model.py:388-434). `cameras` is a batched Camera."""
        dists, valid = per_cam(self.xyz, cameras, znear)
        distance = dists.amin(dim=0)
        seen = valid.any(dim=0)
        # Unseen splats get the max distance among seen ones.
        fallback = torch.where(seen, distance, -torch.inf).max()
        distance = torch.where(seen, distance, fallback)
        mip = (distance / cameras.fx.max() * filter_variance ** 0.5)[..., None]
        return self.replace(mip_filter=mip, use_mip_filter=True)

    # ----------------------------------------------------------- construction
    @staticmethod
    def empty(capacity: int, max_sh_degree: int = 3,
              device: DeviceLike = None) -> "GaussianScene":
        dev = resolve_device(device)
        K = sh_lib.num_sh_coeffs(max_sh_degree)
        f32 = dict(dtype=torch.float32, device=dev)
        return GaussianScene(
            xyz=torch.zeros((capacity, 3), **f32),
            f_dc=torch.zeros((capacity, 1, 3), **f32),
            f_rest=torch.zeros((capacity, K - 1, 3), **f32),
            opacity_raw=torch.full((capacity, 1), -10.0, **f32),
            scaling_raw=torch.full((capacity, 2), -10.0, **f32),
            rotation_raw=torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(capacity, 1),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            mip_filter=torch.zeros((capacity, 1), **f32),
            max_sh_degree=max_sh_degree,
        )

    @staticmethod
    def from_points(
        points: np.ndarray,
        colors: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        max_sh_degree: int = 3,
        initial_opacity: float = 0.1,
        scales: Optional[np.ndarray] = None,
        quats: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ) -> "GaussianScene":
        """Seed a scene from a point cloud (reference create_from_pcd,
        gaussian_model.py:198-232). If `scales` is None, tangent scales are
        sqrt(mean 3-NN squared distance) per point (simple-knn's distCUDA2)."""
        from g4splat_torch.ops.knn import mean_knn_sq_dist

        dev = resolve_device(device)
        n = points.shape[0]
        capacity = capacity or n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} points")
        scene = GaussianScene.empty(capacity, max_sh_degree, device=dev)

        def f32(x):
            if torch.is_tensor(x):
                return x.to(dev, torch.float32)
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        pts = f32(points)
        if scales is None:
            d2 = torch.clamp(mean_knn_sq_dist(pts), min=1e-7)
            s = torch.sqrt(d2)[:, None].repeat(1, 2)
        else:
            s = f32(scales)
            if s.ndim == 1:
                s = s[:, None].repeat(1, 2)
        q = (torch.tensor([[1.0, 0, 0, 0]], device=dev).repeat(n, 1)
             if quats is None else f32(quats))
        dc = (torch.zeros((n, 1, 3), device=dev) if colors is None
              else sh_lib.rgb_to_sh0(f32(colors))[:, None, :])
        op = float(np.log(initial_opacity / (1 - initial_opacity)))
        xyz, f_dc, scaling_raw, rotation_raw, opacity_raw, alive = (
            scene.xyz.clone(), scene.f_dc.clone(), scene.scaling_raw.clone(),
            scene.rotation_raw.clone(), scene.opacity_raw.clone(),
            scene.alive.clone())
        xyz[:n] = pts
        f_dc[:n] = dc
        scaling_raw[:n] = torch.log(s)
        rotation_raw[:n] = q
        opacity_raw[:n] = op
        alive[:n] = True
        return scene.replace(xyz=xyz, f_dc=f_dc, scaling_raw=scaling_raw,
                             rotation_raw=rotation_raw, opacity_raw=opacity_raw,
                             alive=alive)

    # ------------------------------------------------------------------- mesh
    def tetra_points(self, downsample_ratio: float = 1.0,
                     flatness: float = 2e-4, seed: int = 0):
        """Candidate tetrahedralization vertices on the host (numpy): 8 box
        corners + centre per (optionally subsampled) live surfel, the flat
        axis padded to `flatness` (gaussian_model.py:318-382). Rows with a
        non-finite position, scale or rotation are dropped first (they would
        abort Qhull). Returns (points (9n, 3), per-point scale (9n,))."""
        with torch.no_grad():
            xyz = self.xyz.cpu().numpy()
            alive = self.alive.cpu().numpy()
            R = self.rotmats().cpu().numpy()
            s2 = self.scaling().cpu().numpy()
        xyz, R, s2 = xyz[alive], R[alive], s2[alive]
        finite = (np.isfinite(xyz).all(1) & np.isfinite(s2).all(1)
                  & np.isfinite(R).all((1, 2)))
        if not finite.all():
            xyz, R, s2 = xyz[finite], R[finite], s2[finite]
        n = xyz.shape[0]
        if downsample_ratio < 1.0 and n > 0:
            rng = np.random.default_rng(seed)
            keep = rng.choice(n, max(1, int(n * downsample_ratio)), replace=False)
            xyz, R, s2 = xyz[keep], R[keep], s2[keep]
            n = xyz.shape[0]
        s3 = np.concatenate([s2, np.full((n, 1), flatness, np.float32)], axis=1)
        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32)
        offs = np.einsum("nij,cj,nj->nci", R, corners, s3)
        pts = np.concatenate([(xyz[:, None, :] + offs).reshape(-1, 3), xyz], axis=0)
        scale = np.max(s3, axis=1)
        return pts, np.concatenate([np.repeat(scale, 8), scale], axis=0)
