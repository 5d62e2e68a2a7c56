"""COLMAP sparse-model IO, binary and text (a copy of
`g4splat_tpu.io.colmap`: standard library and numpy only).

The standard COLMAP `sparse/0/{cameras,images,points3D}.{bin,txt}` format
(colmap.github.io/format.html), which the SfM stage writes and the reference's
tools read. Cameras are intrinsics records, images carry the world→camera
pose as a wxyz quaternion and a translation, points3D carry xyz, rgb, error
and their observation track. `to_framework_cameras` builds the port's
`Camera`s (on the device the caller names; the card by default).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# model_id → (name, num_params). Params follow COLMAP conventions.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NPARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        elif self.model == "PINHOLE":
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:
            # Distortion models: use the pinhole part.
            fx, fy, cx, cy = p[0], p[1] if self.model != "SIMPLE_RADIAL" else p[0], p[-3], p[-2]
            if self.model == "SIMPLE_RADIAL":
                fx = fy = p[0]
                cx, cy = p[1], p[2]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray       # (4,) wxyz, world→camera rotation
    tvec: np.ndarray       # (3,) world→camera translation
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def w2c(self) -> np.ndarray:
        R = _qvec2rotmat(self.qvec)
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = self.tvec
        return M


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R) -> np.ndarray:
    """Rotation matrix → wxyz quaternion (COLMAP's eigenvalue method)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ----------------------------------------------------------------- binary IO
def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, nparams = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * nparams, "d" * nparams))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def write_cameras_binary(cams: Dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n2d,) = _read(f, 8, "Q")
            data = _read(f, 24 * n2d, "ddq" * n2d)
            xys = np.column_stack([data[0::3], data[1::3]]) if n2d else np.zeros((0, 2))
            pids = np.array(data[2::3], np.int64) if n2d else np.zeros(0, np.int64)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, pids)
    return images


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n2d = len(im.xys)
            f.write(struct.pack("<Q", n2d))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def read_points3D_binary(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            pid = _read(f, 8, "q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"), np.uint8)
            (err,) = _read(f, 8, "d")
            (track_len,) = _read(f, 8, "Q")
            track = _read(f, 8 * track_len, "ii" * track_len)
            pts[pid] = ColmapPoint3D(
                pid, xyz, rgb, err,
                np.array(track[0::2], np.int32),
                np.array(track[1::2], np.int32),
            )
    return pts


def write_points3D_binary(pts: Dict[int, ColmapPoint3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, p2d in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(p2d)))


# ------------------------------------------------------------------- text IO
def write_cameras_text(cams: Dict[int, ColmapCamera], path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]),
            )
    return cams


def write_images_text(images: Dict[int, ColmapImage], path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(
                f"{x} {y} {int(pid)}" for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(obs + "\n")


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        # Keep empty lines: an image with zero observations writes an empty
        # second line, and the 2-lines-per-image pairing must survive.
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9] if len(el) > 9 else ""
        xys = np.zeros((0, 2))
        pids = np.zeros(0, np.int64)
        if i + 1 < len(lines) and lines[i + 1]:
            vals = lines[i + 1].split()
            if vals:
                arr = np.array(vals, dtype=np.float64).reshape(-1, 3)
                xys = arr[:, :2]
                pids = arr[:, 2].astype(np.int64)
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, pids)
    return images


def write_points3D_text(pts: Dict[int, ColmapPoint3D], path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(pts)}\n")
        for p in pts.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            track = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {p.error} {track}\n")


def read_points3D_text(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            xyz = np.array([float(x) for x in el[1:4]])
            rgb = np.array([int(x) for x in el[4:7]], np.uint8)
            err = float(el[7])
            track = np.array(el[8:], dtype=np.float64).reshape(-1, 2)
            pts[pid] = ColmapPoint3D(
                pid, xyz, rgb, err,
                track[:, 0].astype(np.int32), track[:, 1].astype(np.int32),
            )
    return pts


# ------------------------------------------------------------- model helpers
def write_model(cams, images, pts, out_dir, binary=True, text=True):
    os.makedirs(out_dir, exist_ok=True)
    if binary:
        write_cameras_binary(cams, os.path.join(out_dir, "cameras.bin"))
        write_images_binary(images, os.path.join(out_dir, "images.bin"))
        write_points3D_binary(pts, os.path.join(out_dir, "points3D.bin"))
    if text:
        write_cameras_text(cams, os.path.join(out_dir, "cameras.txt"))
        write_images_text(images, os.path.join(out_dir, "images.txt"))
        write_points3D_text(pts, os.path.join(out_dir, "points3D.txt"))


def read_model(model_dir):
    """Read sparse model, preferring binary."""
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        return (
            read_cameras_binary(os.path.join(model_dir, "cameras.bin")),
            read_images_binary(os.path.join(model_dir, "images.bin")),
            read_points3D_binary(os.path.join(model_dir, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(model_dir, "cameras.txt")),
        read_images_text(os.path.join(model_dir, "images.txt")),
        read_points3D_text(os.path.join(model_dir, "points3D.txt")),
    )


def to_framework_cameras(cams: Dict[int, ColmapCamera],
                         images: Dict[int, ColmapImage],
                         znear: float = 0.01, zfar: float = 100.0, device=None):
    """COLMAP model → list of (name, Camera), sorted by name."""
    from g4splat_torch.core.cameras import make_camera

    out = []
    for im in sorted(images.values(), key=lambda i: i.name):
        cam = cams[im.camera_id]
        K = cam.K
        out.append(
            (
                im.name,
                make_camera(
                    im.w2c(), K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                    cam.width, cam.height, znear=znear, zfar=zfar, device=device,
                ),
            )
        )
    return out
