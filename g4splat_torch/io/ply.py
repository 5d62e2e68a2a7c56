"""Minimal dependency-free binary PLY IO (counterpart of `g4splat_tpu.io.ply`).

Round-trips the reference's on-disk Gaussian schema
(2d-gaussian-splatting/scene/gaussian_model.py:276-316: x y z, nx ny nz,
f_dc_*, f_rest_*, opacity, scale_*, rot_*, optional mip_filter — float32
little-endian), point clouds (`save_point_cloud_ply`) and triangle meshes
(`save_mesh_ply`). Files
written here and by the JAX package are interchangeable; the two differ only
in the header's comment line.
"""

from __future__ import annotations

import io as _io
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from g4splat_torch.device import DeviceLike, resolve_device

_PLY_TO_NP = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_NP_TO_PLY = {v: k for k, v in list(_PLY_TO_NP.items())[:8]}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a binary PLY → {element_name: structured array}. A list property
    (a mesh's `vertex_indices`) comes back as an (M, L) array under its
    element's name; lists must all have the first row's length. Ascii files
    and variable-length lists are refused."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = "binary_little_endian"
    elements = []  # [name, count, [(prop, dtype)], (count dtype, index dtype) or None]
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), [], None])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][3] = (_PLY_TO_NP[parts[2]], _PLY_TO_NP[parts[3]])
            else:
                elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))
    if fmt not in ("binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: PLY format {fmt!r} is not supported")

    endian = "<" if "little" in fmt else ">"
    out: Dict[str, np.ndarray] = {}
    off = 0
    for name, count, props, list_prop in elements:
        if list_prop is None:
            dt = np.dtype([(p, endian + t) for p, t in props])
            out[name] = np.frombuffer(body, dt, count=count, offset=off)
            off += dt.itemsize * count
            continue
        if props:
            raise ValueError(f"{path}: element {name!r} mixes list and scalar properties")
        cnt_t = np.dtype(endian + list_prop[0])
        length = int(np.frombuffer(body, cnt_t, count=1, offset=off)[0]) if count else 0
        row_dt = np.dtype([("n", cnt_t), ("v", endian + list_prop[1], (length,))])
        rows = np.frombuffer(body, row_dt, count=count, offset=off)
        if (rows["n"] != length).any():
            raise ValueError(f"{path}: variable-length PLY list properties are not supported")
        out[name] = rows["v"].copy()
        off += row_dt.itemsize * count
    return out


def write_ply(path: str, vertex_fields: Dict[str, np.ndarray],
              faces: Optional[np.ndarray] = None,
              comment: str = "generated by g4splat_torch"):
    """Write a binary little-endian PLY. `vertex_fields` maps property name →
    (N,) array (order preserved); `faces`, an (F, L) index array, becomes a
    `face` element of `vertex_indices` lists (uchar count, int indices)."""
    names = list(vertex_fields)
    n = len(vertex_fields[names[0]])
    cols = []
    for k in names:
        v = np.asarray(vertex_fields[k])
        if v.shape != (n,):
            raise ValueError(f"field {k} must be flat (N,), got {v.shape}")
        cols.append(v)

    buf = _io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"comment {comment}\n".encode())
    buf.write(f"element vertex {n}\n".encode())
    dt_fields = []
    for k, v in zip(names, cols):
        t = v.dtype.str.lstrip("<>|=")
        buf.write(f"property {_NP_TO_PLY.get(t, 'float')} {k}\n".encode())
        dt_fields.append((k, "<" + t))
    if faces is not None:
        faces = np.asarray(faces, np.int32)
        buf.write(f"element face {len(faces)}\n".encode())
        buf.write(b"property list uchar int vertex_indices\n")
    buf.write(b"end_header\n")

    rec = np.zeros(n, np.dtype(dt_fields))
    for k, v in zip(names, cols):
        rec[k] = v
    buf.write(rec.tobytes())
    if faces is not None:
        frec = np.zeros(len(faces), np.dtype([("n", "u1"), ("v", "<i4", (faces.shape[1],))]))
        frec["n"] = faces.shape[1]
        frec["v"] = faces
        buf.write(frec.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def save_point_cloud_ply(path: str, points, colors=None, normals=None) -> None:
    """A point cloud as binary PLY: float32 x y z, optional float32 nx ny nz,
    optional uchar red green blue (float colours: clip to [0, 1], × 255,
    truncated to uint8)."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    pts = host(points).astype(np.float32)
    fields = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}
    if normals is not None:
        nm = host(normals).astype(np.float32)
        fields.update({"nx": nm[:, 0], "ny": nm[:, 1], "nz": nm[:, 2]})
    if colors is not None:
        c = host(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        fields.update({"red": c[:, 0], "green": c[:, 1], "blue": c[:, 2]})
    write_ply(path, fields)


def save_mesh_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
                  vertex_colors: Optional[np.ndarray] = None) -> None:
    """A triangle mesh as binary PLY: float32 x y z, uchar red green blue
    (float colours: clip to [0, 1], × 255, truncated to uint8, as the JAX
    package writes them), int faces."""
    v = np.asarray(vertices, np.float32)
    fields = {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]}
    if vertex_colors is not None:
        c = np.asarray(vertex_colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
        fields.update({"red": c[:, 0], "green": c[:, 1], "blue": c[:, 2]})
    write_ply(path, fields, faces=np.asarray(faces, np.int32))


def load_mesh_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(vertices (V, 3) float32, faces (F, 3) or None, uint8 colours or None)."""
    d = read_ply(path)
    v = d["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    colors = None
    if v.dtype.names and "red" in v.dtype.names:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1)
    return verts, d.get("face"), colors


# --------------------------------------------------------------- Gaussians IO
def save_gaussian_ply(path: str, scene) -> None:
    """Write a GaussianScene in the reference's point_cloud.ply schema (alive
    splats only; a scene with none alive writes a valid empty file)."""

    def np_(t):
        return t.detach().cpu().numpy()

    alive = np_(scene.alive)
    xyz = np_(scene.xyz)[alive]
    n = xyz.shape[0]
    # Features are stored channel-major: transpose(1,2).flatten
    # (gaussian_model.py:297-298). Explicit column counts keep n == 0 legal.
    f_dc_a = np_(scene.f_dc)
    f_rest_a = np_(scene.f_rest)
    f_dc = f_dc_a[alive].transpose(0, 2, 1).reshape(n, f_dc_a.shape[1] * f_dc_a.shape[2])
    f_rest = f_rest_a[alive].transpose(0, 2, 1).reshape(
        n, f_rest_a.shape[1] * f_rest_a.shape[2])
    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    for k in ("nx", "ny", "nz"):
        fields[k] = np.zeros(n, np.float32)
    for i in range(f_dc.shape[1]):
        fields[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    for i in range(f_rest.shape[1]):
        fields[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
    fields["opacity"] = np_(scene.opacity_raw)[alive, 0].astype(np.float32)
    sc = np_(scene.scaling_raw)[alive]
    for i in range(sc.shape[1]):
        fields[f"scale_{i}"] = sc[:, i].astype(np.float32)
    rot = np_(scene.rotation_raw)[alive]
    for i in range(rot.shape[1]):
        fields[f"rot_{i}"] = rot[:, i].astype(np.float32)
    if scene.use_mip_filter:
        fields["mip_filter"] = np_(scene.mip_filter)[alive, 0].astype(np.float32)
    write_ply(path, fields)


def _indexed(names, prefix):
    return sorted((x for x in names if x.startswith(prefix)),
                  key=lambda x: int(x.split("_")[-1]))


def load_gaussian_ply(path: str, capacity: Optional[int] = None,
                      max_sh_degree: int = 3, device: DeviceLike = None):
    """Read a reference-schema point_cloud.ply into a GaussianScene
    (gaussian_model.py:441-497 load_ply equivalent)."""
    from g4splat_torch.models.gaussians import GaussianScene

    dev = resolve_device(device)
    v = read_ply(path)["vertex"]
    names = v.dtype.names
    n = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rest_names = _indexed(names, "f_rest_")
    f_rest = (np.stack([v[x] for x in rest_names], axis=1).astype(np.float32)
              if rest_names else np.zeros((n, 0), np.float32))
    n_rest_coeff = len(rest_names) // 3
    # On-disk layout is channel-major (3, K-1) flattened.
    f_rest = f_rest.reshape(n, 3, n_rest_coeff).transpose(0, 2, 1)
    opacity = v["opacity"].astype(np.float32)[:, None]
    scaling = np.stack([v[x] for x in _indexed(names, "scale_")], axis=1).astype(np.float32)
    rot = np.stack([v[x] for x in _indexed(names, "rot_")], axis=1).astype(np.float32)

    deg = int(round((n_rest_coeff + 1) ** 0.5)) - 1
    max_sh_degree = max(max_sh_degree, deg)
    capacity = capacity or n
    scene = GaussianScene.empty(capacity, max_sh_degree=max_sh_degree, device=dev)
    K = (max_sh_degree + 1) ** 2
    fr = np.zeros((n, K - 1, 3), np.float32)
    fr[:, :n_rest_coeff] = f_rest

    def put(base, rows):
        out = base.clone()
        out[:n] = torch.as_tensor(rows, device=dev)
        return out

    scene = scene.replace(
        xyz=put(scene.xyz, xyz),
        f_dc=put(scene.f_dc, f_dc[:, None, :]),
        f_rest=put(scene.f_rest, fr),
        opacity_raw=put(scene.opacity_raw, opacity),
        scaling_raw=put(scene.scaling_raw, scaling[:, :2]),
        rotation_raw=put(scene.rotation_raw, rot),
        alive=put(scene.alive, np.ones(n, bool)),
        active_sh_degree=deg,
    )
    if "mip_filter" in names:
        mf = v["mip_filter"].astype(np.float32)[:, None]
        scene = scene.replace(mip_filter=put(scene.mip_filter, mf),
                              use_mip_filter=True)
    return scene
