"""Synthetic box room: known geometry, known images (counterpart of
`g4splat_tpu.eval.synthetic`).

`box_room()` gives three walls, a floor and a box as surfel splats sampled
on the surfaces (normal-aligned disks, procedural multi-frequency texture)
together with the exact GT triangle mesh of those surfaces;
`room_cameras()` a ring of cameras inside the room; `cull_mesh_to_views()`
the part of the GT mesh the cameras see. The arrays come from
`np.random.RandomState(seed)` and numpy, as in the JAX package, so both
packages build the same room. `quality_run` (the posed pipeline tail on this
room) waits for the pipeline shell.
"""

from typing import Tuple

import numpy as np

from g4splat_torch.core.cameras import lookat_camera, stack_cameras
from g4splat_torch.device import DeviceLike
from g4splat_torch.models.gaussians import GaussianScene


def _normal_quats(normals: np.ndarray) -> np.ndarray:
    """(w,x,y,z) quaternions rotating the disk normal +z onto ``normals``."""
    z = np.array([0.0, 0.0, 1.0], np.float32)
    n = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                             1e-9)
    w = 1.0 + n @ z                      # = 1 + cos(theta)
    axis = np.cross(np.tile(z, (len(n), 1)), n)
    # Antipodal (n == -z): rotate pi about x.
    flip = w < 1e-6
    axis[flip] = [1.0, 0.0, 0.0]
    w = np.where(flip, 0.0, w)
    q = np.concatenate([w[:, None], axis], axis=1).astype(np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)


def _texture(p: np.ndarray) -> np.ndarray:
    """Deterministic multi-frequency RGB texture over 3D points."""
    f = np.stack([
        np.sin(3.1 * p[:, 0] + 1.7 * p[:, 2]),
        np.sin(2.3 * p[:, 1] + 2.9 * p[:, 0] + 1.0),
        np.sin(4.1 * p[:, 2] + 1.3 * p[:, 1] + 2.0),
    ], axis=1)
    checker = ((np.floor(p[:, 0] * 2.5) + np.floor(p[:, 2] * 2.5)) % 2.0)
    return (0.45 + 0.3 * f + 0.2 * checker[:, None]).clip(0.02, 0.98)


def _plane_patch(origin, u, v, rng, density, grid_spacing=0.025):
    """Sample points + (normal, grid mesh) for a rectangle patch.

    The mesh is a ``grid_spacing``-spaced triangle grid, NOT two big quads:
    the reference's Chamfer protocol (mesh_eval.py:28-40) compares voxel-
    downsampled VERTEX clouds, which is only meaningful when vertices
    densely cover the surface (true for Replica scan meshes). Corner-only
    quads made every predicted vertex ~0.6 m from its nearest GT vertex."""
    uu = rng.uniform(0, 1, (density, 1))
    vv = rng.uniform(0, 1, (density, 1))
    pts = (np.asarray(origin)[None]
           + uu * np.asarray(u)[None] + vv * np.asarray(v)[None])
    nrm = np.cross(u, v)
    nrm = nrm / np.linalg.norm(nrm)
    o = np.asarray(origin, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    nu = max(int(np.ceil(np.linalg.norm(u) / grid_spacing)), 1)
    nv = max(int(np.ceil(np.linalg.norm(v) / grid_spacing)), 1)
    gu = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    gv = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    verts = (o[None, None]
             + gu[:, None, None] * u[None, None]
             + gv[None, :, None] * v[None, None]).reshape(-1, 3)
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)
    return pts.astype(np.float32), nrm.astype(np.float32), verts, faces


def box_room(points_per_m2: int = 9000, seed: int = 0, device: DeviceLike = None
             ) -> Tuple[GaussianScene, Tuple[np.ndarray, np.ndarray]]:
    """GT splat scene (opacity 0.95, on `device`) + exact mesh (vertices,
    faces). Room: floor y = +1, back wall z = +1.5, side walls x = ±1.5, and
    a 0.6 cube on the floor."""
    rng = np.random.RandomState(seed)
    patches = [
        ([-1.5, 1.0, -1.5], [3.0, 0, 0], [0, 0, 3.0]),     # floor y = 1
        ([-1.5, -1.0, 1.5], [3.0, 0, 0], [0, 2.0, 0]),     # back wall z = 1.5
        ([-1.5, -1.0, -1.5], [0, 0, 3.0], [0, 2.0, 0]),    # left wall x = -1.5
        ([1.5, -1.0, -1.5], [0, 2.0, 0], [0, 0, 3.0]),     # right wall x = 1.5
    ]
    # 0.6 cube on the floor, centred at (0.2, 0.7, 0.3)
    c, h = np.array([0.2, 0.7, 0.3]), 0.3
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            if axis == 1 and sgn > 0:
                continue  # the bottom face touches the floor
            u = np.zeros(3)
            v = np.zeros(3)
            u[(axis + 1) % 3] = 2 * h
            v[(axis + 2) % 3] = 2 * h * sgn  # winding flips with the side
            o = c.copy()
            o[axis] += sgn * h
            o[(axis + 1) % 3] -= h
            o[(axis + 2) % 3] -= h * sgn
            patches.append((o.tolist(), u.tolist(), v.tolist()))

    pts_all, quats_all, verts_all, faces_all = [], [], [], []
    voff = 0
    for origin, u, v in patches:
        area = np.linalg.norm(np.cross(u, v))
        dens = max(int(points_per_m2 * area), 64)
        pts, nrm, verts, faces = _plane_patch(origin, u, v, rng, dens)
        pts_all.append(pts)
        quats_all.append(_normal_quats(np.tile(nrm, (len(pts), 1))))
        verts_all.append(verts)
        faces_all.append(faces + voff)
        voff += len(verts)
    pts = np.concatenate(pts_all)
    quats = np.concatenate(quats_all)
    cols = _texture(pts).astype(np.float32)
    # Disk radius from the sampling density: ~2x the mean spacing closes holes.
    scales = np.full(len(pts), 2.2 / np.sqrt(points_per_m2), np.float32)
    gt = GaussianScene.from_points(pts, cols, scales=scales, quats=quats,
                                   initial_opacity=0.95, device=device)
    return gt, (np.concatenate(verts_all), np.concatenate(faces_all))


def cull_mesh_to_views(verts: np.ndarray, faces: np.ndarray, cameras,
                       depths: np.ndarray, tol: float = 0.05):
    """The part of a GT mesh the cameras observe: a vertex is kept when some
    camera sees it in its image and within `tol` of that camera's depth map
    (frustum + occlusion test); faces keep only fully visible triangles.
    Host numpy; `depths` is (V, H, W)."""
    keep = np.zeros(len(verts), bool)
    w2cs = cameras.w2c.detach().cpu().numpy()
    fxs, fys, cxs, cys = (getattr(cameras, k).detach().cpu().numpy()
                          for k in ("fx", "fy", "cx", "cy"))
    for i in range(len(w2cs)):
        w2c = w2cs[i]
        p = verts @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = p[:, 0] / z * float(fxs[i]) + float(cxs[i])
            v = p[:, 1] / z * float(fys[i]) + float(cys[i])
        H, W = depths[i].shape
        inb = (z > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        ui = np.clip(u.astype(np.int64), 0, W - 1)
        vi = np.clip(v.astype(np.int64), 0, H - 1)
        keep |= inb & (z <= depths[i][vi, ui] + tol)
    fkeep = keep[faces].all(axis=1)
    used = np.unique(faces[fkeep])
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces[fkeep]].astype(np.int32)


def inward_cameras(n: int, width: int, height: int, device: DeviceLike = None):
    """Ring of n cameras of radius 1 around (0, -0.2, 0.1), above the box,
    each looking across the room and down (80° horizontal field of view).
    Unlike `room_cameras`, whose eyes sit at the open front, outside the
    space the views observe, the ring's own orbit lies in observed space, so
    the See3D stage-1 proposals (an orbit at the cameras' radius) survive
    the visibility grid."""
    cams = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False) + 0.3:
        d = np.array([np.sin(a), 0.0, np.cos(a)])
        cams.append(lookat_camera(np.array([0.0, -0.2, 0.1]) + d,
                                  np.array([0.0, 0.45, 0.1]) - 1.2 * d, [0, -1, 0],
                                  fx=0.6 * width, fy=0.6 * width, width=width,
                                  height=height, device=device))
    return stack_cameras(cams)


def room_cameras(n: int, width: int, height: int, device: DeviceLike = None):
    """Ring of n cameras inside the room looking past the box."""
    cams = []
    for a in np.linspace(-0.75, 0.75, n):
        eye = [1.1 * np.sin(a), -0.25 + 0.1 * np.cos(3 * a), -1.4 + 0.15 * np.cos(a)]
        tgt = [0.25 * np.sin(a * 0.5), 0.45, 0.6]
        cams.append(lookat_camera(eye, tgt, [0, -1, 0], fx=width * 0.85, fy=width * 0.85,
                                  width=width, height=height, device=device))
    return stack_cameras(cams)
