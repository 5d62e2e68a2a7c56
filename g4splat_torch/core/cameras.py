"""Camera model (counterpart of `g4splat_tpu.core.cameras`).

Conventions:
- ``w2c`` is the 4x4 world→camera matrix, column-vector convention, OpenCV
  axes: +x right, +y down, +z forward.
- Intrinsics ``fx, fy, cx, cy`` are 0-d tensors in pixels; image size and
  clip planes are plain Python metadata.
- NDC→pixel uses the reference's ``x_pix = (W/2)·x_ndc + (W-1)/2`` mapping
  (diff-surfel-rasterization/cuda_rasterizer/forward.cu:106-110).

A batch of cameras is a `Camera` whose tensors carry a leading batch axis
(`stack_cameras`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from g4splat_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Camera:
    w2c: torch.Tensor          # (…, 4, 4) world→camera
    fx: torch.Tensor           # (…) focal, pixels
    fy: torch.Tensor
    cx: torch.Tensor           # (…) principal point, pixels
    cy: torch.Tensor
    width: int = 0
    height: int = 0
    znear: float = 0.01
    zfar: float = 100.0

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(w2c=self.w2c.to(device), fx=self.fx.to(device),
                            fy=self.fy.to(device), cx=self.cx.to(device),
                            cy=self.cy.to(device))

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    # ------------------------------------------------------------------ poses
    @property
    def c2w(self) -> torch.Tensor:
        """(…, 4, 4) camera→world (inverse of the rigid w2c, closed form)."""
        R = self.w2c[..., :3, :3]
        t = self.w2c[..., :3, 3]
        Rt = R.transpose(-1, -2)
        top = torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @property
    def center(self) -> torch.Tensor:
        """(…, 3) camera origin in world space."""
        return self.c2w[..., :3, 3]

    # ------------------------------------------------------------ projections
    @property
    def projection(self) -> torch.Tensor:
        """(…, 4, 4) camera→NDC projection (reference getProjectionMatrix,
        generalized to off-center principal points)."""
        W, H = float(self.width), float(self.height)
        zn, zf = self.znear, self.zfar
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        p00 = 2.0 * self.fx / W
        p11 = 2.0 * self.fy / H
        p02 = (2.0 * self.cx - (W - 1.0)) / W
        p12 = (2.0 * self.cy - (H - 1.0)) / H
        p22 = o * (zf / (zf - zn))
        p23 = o * (-(zf * zn) / (zf - zn))
        return torch.stack(
            [
                torch.stack([p00, z, p02, z], dim=-1),
                torch.stack([z, p11, p12, z], dim=-1),
                torch.stack([z, z, p22, p23], dim=-1),
                torch.stack([z, z, o, z], dim=-1),
            ],
            dim=-2,
        )

    @property
    def full_proj(self) -> torch.Tensor:
        """(…, 4, 4) world→NDC: projection ∘ w2c."""
        return self.projection @ self.w2c

    @property
    def ndc2pix(self) -> torch.Tensor:
        """(3, 4) homogeneous NDC→pixel map (reference forward.cu:106-110)."""
        W, H = float(self.width), float(self.height)
        return torch.tensor(
            [
                [W / 2.0, 0.0, 0.0, (W - 1.0) / 2.0],
                [0.0, H / 2.0, 0.0, (H - 1.0) / 2.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=torch.float32, device=self.device,
        )

    @property
    def world2pix(self) -> torch.Tensor:
        """(…, 3, 4) world → homogeneous pixel (x·w, y·w, w), w = view-depth."""
        return self.ndc2pix @ self.full_proj

    # ------------------------------------------------------------------- rays
    def pixel_rays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """World-space rays through every pixel center: (origin (3,),
        directions (H, W, 3)) with unit view-z, so ``origin + z·dir`` lands on
        the surface at view depth z."""
        ys, xs = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=self.device),
            torch.arange(self.width, dtype=torch.float32, device=self.device),
            indexing="ij",
        )
        dirs_cam = torch.stack(
            [(xs - self.cx) / self.fx, (ys - self.cy) / self.fy,
             torch.ones_like(xs)],
            dim=-1,
        )
        R_c2w = self.c2w[:3, :3]
        return self.center, dirs_cam @ R_c2w.T

    def backproject(self, depth: torch.Tensor) -> torch.Tensor:
        """(H, W) view-z depth map → (H, W, 3) world points."""
        origin, dirs = self.pixel_rays()
        return origin + depth[..., None] * dirs

    def project(self, pts_world: torch.Tensor, eps: float = 1e-8):
        """(…, 3) world points → pixel coords (…, 2) and view depth (…,)."""
        return project_points(self.world2pix, pts_world, eps)


def project_points(world2pix: torch.Tensor, pts_world: torch.Tensor, eps: float = 1e-8):
    """`Camera.project` through a precomputed (3, 4) world→pixel matrix:
    pixel coords (…, 2) = (x·w, y·w) / (w + eps) and view depth w (…,)."""
    ph = pts_world @ world2pix[:, :3].T + world2pix[:, 3]
    z = ph[..., 2]
    return ph[..., :2] / (z[..., None] + eps), z


def make_camera(
    w2c,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    device: DeviceLike = None,
) -> Camera:
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    return Camera(w2c=f32(w2c), fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                  width=int(width), height=int(height), znear=float(znear),
                  zfar=float(zfar))


def stack_cameras(cams) -> Camera:
    """Stack same-size Cameras into one batched Camera."""
    if len({(c.width, c.height, c.znear, c.zfar) for c in cams}) != 1:
        raise ValueError("batched cameras must share static metadata")
    c0 = cams[0]
    return c0.replace(**{
        k: torch.stack([getattr(c, k) for c in cams])
        for k in ("w2c", "fx", "fy", "cx", "cy")
    })


def camera_at(cameras: Camera, v: int) -> Camera:
    """The v-th camera of a batched Camera."""
    return cameras.replace(**{k: getattr(cameras, k)[v]
                              for k in ("w2c", "fx", "fy", "cx", "cy")})


def interpolate_cameras(cameras: Camera, n_neighbors: int = 2,
                        n_per_neighbor: int = 10) -> Camera:
    """Cameras between each camera and its nearest neighbours by centre
    (the reference's interpolated TSDF views; configs/
    adaptive_tetrahedralization: 2 neighbours, 10 cameras each): rotation
    slerp through quaternions, linear centre and intrinsics. Host numpy,
    as in the JAX package; the result lies on the cameras' device."""
    import numpy as np

    from g4splat_torch.core.transforms import quat_to_rotmat, rotmat_to_quat

    V = cameras.w2c.shape[0]
    centers = cameras.center.detach().cpu().numpy()
    fx, fy, cx, cy = (getattr(cameras, k).detach().cpu().numpy()
                      for k in ("fx", "fy", "cx", "cy"))
    quats = rotmat_to_quat(cameras.w2c[:, :3, :3].detach().cpu()).numpy()

    def slerp(q0, q1, t):
        d = float(np.dot(q0, q1))
        if d < 0:
            q1, d = -q1, -d
        if d > 0.9995:
            q = q0 + t * (q1 - q0)
            return q / np.linalg.norm(q)
        th = np.arccos(np.clip(d, -1, 1))
        return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)

    out = []
    for i in range(V):
        d = np.linalg.norm(centers - centers[i], axis=1)
        d[i] = np.inf
        for j in np.argsort(d)[: min(n_neighbors, V - 1)]:
            j = int(j)
            for k in range(1, n_per_neighbor + 1):
                t = k / (n_per_neighbor + 1)
                q = slerp(quats[i], quats[j], t)
                R = quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()
                c = (1 - t) * centers[i] + t * centers[j]
                m = np.eye(4, dtype=np.float32)
                m[:3, :3] = R
                m[:3, 3] = -R @ c
                out.append(make_camera(
                    m, (1 - t) * fx[i] + t * fx[j], (1 - t) * fy[i] + t * fy[j],
                    (1 - t) * cx[i] + t * cx[j], (1 - t) * cy[i] + t * cy[j],
                    cameras.width, cameras.height, znear=cameras.znear,
                    zfar=cameras.zfar, device=cameras.device))
    return stack_cameras(out)


def lookat_camera(eye, target, up, fx, fy, width, height,
                  device: DeviceLike = None, **kw) -> Camera:
    """Camera looking from `eye` toward `target` (OpenCV axes)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    up = torch.as_tensor(up, dtype=torch.float32)
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=1).T    # rows = camera axes
    w2c = torch.eye(4, dtype=torch.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return make_camera(w2c, fx, fy, (width - 1) / 2.0, (height - 1) / 2.0,
                       width, height, device=device, **kw)
