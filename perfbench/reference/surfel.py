"""Plain PyTorch 2DGS surfel rendering: the benchmark's reference for the
render path of a training step, and the walk its B1 and B2 counts read.

An independent statement of what the timed renderer computes, written from
the surfel formulation of the reference CUDA rasterizer
(diff-surfel-rasterization/cuda_rasterizer/forward.cu) and its wrapper
(2d-gaussian-splatting/gaussian_renderer/__init__.py):

- a surfel's (u, v, 1) maps to homogeneous pixels through T = world2pix · S
  (forward.cu:75-115); its screen centre and radius come from the dual
  conic (:119-147);
- each splat lands in the tiles of its ±radius rectangle, in row-major
  order, at most `max_tiles` of them; a tile composites its splats in
  order of view depth (ties by splat index);
- a pixel's ray meets the surfel where two homogeneous planes cross
  (:352-366), min'd with a screen low-pass of inverse variance 2; alpha is
  clamped at 0.99, skipped below 1/255, and the walk stops before the splat
  that takes the transmittance under 1e-4 (:377-389).

Tiles are composited in blocks of similar length, each block under
`torch.utils.checkpoint`, so autograd gives the render's vector-Jacobian
product without holding every block's intermediates. Every matrix product
goes through a `precision.Ops`. Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.precision import Ops

TILE = 16
NEAR = 0.2
FAR = 100.0
FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
CUTOFF = 3.0
# (splat, pixel) pairs a block of tiles may hold, padding included.
BLOCK_PAIRS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@dataclass(frozen=True)
class Cam:
    """A pinhole camera: w2c (4, 4) world→camera (OpenCV axes), focal
    lengths and principal point in pixels (0-d tensors)."""
    w2c: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0


def look_at(eye, target, up, focal: float, width: int, height: int, device) -> Cam:
    """A camera at `eye` looking at `target`, principal point at the image
    centre ((W - 1) / 2, (H - 1) / 2)."""
    f32 = dict(dtype=torch.float32)
    eye, target, up = (torch.as_tensor(v, **f32) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / (torch.linalg.norm(fwd) + 1e-12)
    right = torch.linalg.cross(fwd, up)
    right = right / (torch.linalg.norm(right) + 1e-12)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=1).T
    w2c = torch.eye(4, **f32)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye

    def t(x):
        return torch.tensor(float(x), device=device, **f32)

    return Cam(w2c.to(device), t(focal), t(focal), t((width - 1) / 2.0),
               t((height - 1) / 2.0), int(width), int(height))


def world2pix(cam: Cam, ops: Ops) -> torch.Tensor:
    """(3, 4) world → homogeneous pixel (x·w, y·w, w): the NDC→pixel map
    (forward.cu:106-110) after the projection and the view."""
    W, H = float(cam.width), float(cam.height)
    dev = cam.w2c.device
    zn, zf = cam.znear, cam.zfar
    z = torch.zeros((), device=dev)
    o = torch.ones((), device=dev)
    proj = torch.stack([
        torch.stack([2.0 * cam.fx / W, z, (2.0 * cam.cx - (W - 1.0)) / W, z]),
        torch.stack([z, 2.0 * cam.fy / H, (2.0 * cam.cy - (H - 1.0)) / H, z]),
        torch.stack([z, z, o * (zf / (zf - zn)), o * (-(zf * zn) / (zf - zn))]),
        torch.stack([z, z, o, z]),
    ])
    ndc2pix = torch.tensor([[W / 2.0, 0.0, 0.0, (W - 1.0) / 2.0],
                            [0.0, H / 2.0, 0.0, (H - 1.0) / 2.0],
                            [0.0, 0.0, 0.0, 1.0]], device=dev)
    return ops.matmul(ndc2pix, ops.matmul(proj, cam.w2c))


def cam_center(cam: Cam) -> torch.Tensor:
    R, t = cam.w2c[:3, :3], cam.w2c[:3, 3]
    return -(R.T @ t[:, None])[:, 0]


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(P, 4) wxyz quaternions (normalised here) → (P, 3, 3)."""
    w, x, y, z = normalize(q).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def sh_to_rgb(degree: int, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Real SH of degree ≤ 3 (forward.cu:20-71): (P, K, 3) coefficients and
    (P, 3) unit directions → clamp(SH + 0.5, 0)."""
    out = SH_C0 * c[:, 0]
    if degree >= 1:
        x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        out = out - SH_C1 * y * c[:, 1] + SH_C1 * z * c[:, 2] - SH_C1 * x * c[:, 3]
        if degree >= 2:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * c[:, 4] + SH_C2[1] * yz * c[:, 5]
                   + SH_C2[2] * (2.0 * zz - xx - yy) * c[:, 6] + SH_C2[3] * xz * c[:, 7]
                   + SH_C2[4] * (xx - yy) * c[:, 8])
            if degree >= 3:
                out = (out + SH_C3[0] * y * (3.0 * xx - yy) * c[:, 9]
                       + SH_C3[1] * xy * z * c[:, 10]
                       + SH_C3[2] * y * (4.0 * zz - xx - yy) * c[:, 11]
                       + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c[:, 12]
                       + SH_C3[4] * x * (4.0 * zz - xx - yy) * c[:, 13]
                       + SH_C3[5] * z * (xx - yy) * c[:, 14]
                       + SH_C3[6] * x * (xx - 3.0 * yy) * c[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


class Prep(NamedTuple):
    """Per-splat screen quantities, (P, ...)."""
    T: torch.Tensor        # (P, 3, 3) rows Tu, Tv, Tw
    center: torch.Tensor   # (P, 2) low-pass centre, pixels
    radius: torch.Tensor   # (P,)
    depth: torch.Tensor    # (P,) view z of the centre
    normal: torch.Tensor   # (P, 3) camera-facing view normal
    opacity: torch.Tensor  # (P,)
    rgb: torch.Tensor      # (P, 3)
    valid: torch.Tensor    # (P,) bool


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """Truncation toward zero to int32, NaN to 0, saturating."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2147483520.0, 2147483520.0).to(torch.int32)


def tile_rect(center, radius, gx: int, gy: int):
    """[min, max) tile bounds of each splat's ±radius rectangle."""
    x0 = _to_int((center[:, 0] - radius) / TILE).clamp(0, gx)
    y0 = _to_int((center[:, 1] - radius) / TILE).clamp(0, gy)
    x1 = _to_int((center[:, 0] + radius + TILE - 1) / TILE).clamp(0, gx)
    y1 = _to_int((center[:, 1] + radius + TILE - 1) / TILE).clamp(0, gy)
    return x0, y0, x1, y1


def preprocess(cam: Cam, xyz, scaling, rotation_raw, opacity, features, sh_degree: int,
               ops: Ops, center_offset: Optional[torch.Tensor] = None) -> Prep:
    """Project every splat (forward.cu:151-253). `opacity` is (P,)."""
    P = xyz.shape[0]
    R_w2c, t_w2c = cam.w2c[:3, :3], cam.w2c[:3, 3]
    p_view = ops.matmul(xyz, R_w2c.T) + t_w2c
    R = quat_to_rotmat(rotation_raw)
    zeros, ones = xyz.new_zeros((P, 1)), xyz.new_ones((P, 1))
    S = torch.stack([torch.cat([R[:, :, 0] * scaling[:, 0:1], zeros], 1),
                     torch.cat([R[:, :, 1] * scaling[:, 1:2], zeros], 1),
                     torch.cat([xyz, ones], 1)], dim=-1)               # (P, 4, 3)
    T = ops.einsum("ij,pjk->pik", world2pix(cam, ops), S)
    normal = ops.matmul(R[:, :, 2], R_w2c.T)
    cos = -torch.sum(p_view * normal, dim=-1)
    normal = normal * torch.where(cos > 0, 1.0, -1.0)[:, None]

    Tu, Tv, Tw = T[:, 0], T[:, 1], T[:, 2]
    tmp = T.new_tensor([CUTOFF * CUTOFF, CUTOFF * CUTOFF, -1.0])
    dist = torch.sum(Tw * Tw * tmp, dim=-1)
    ok = torch.abs(dist) > 1e-12
    f = tmp / torch.where(ok, dist, 1.0)[:, None]
    center = torch.stack([torch.sum(f * Tu * Tw, -1), torch.sum(f * Tv * Tw, -1)], -1)
    if center_offset is not None:
        center = center + center_offset
    half_sq = center * center - torch.stack([torch.sum(f * Tu * Tu, -1),
                                             torch.sum(f * Tv * Tv, -1)], -1)
    radius = torch.ceil(torch.sqrt(torch.clamp(half_sq, min=1e-4)).max(dim=-1).values)
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)
    x0, y0, x1, y1 = tile_rect(center, radius, gx, gy)
    nonempty = (x1 - x0) * (y1 - y0) > 0
    rgb = sh_to_rgb(sh_degree, features, normalize(xyz - cam_center(cam)))
    valid = (p_view[:, 2] >= NEAR) & ok & nonempty & (opacity >= ALPHA_EPS)
    return Prep(T, torch.where(valid[:, None], center, 0.0), torch.where(valid, radius, 0.0),
                p_view[:, 2], normal, opacity, rgb, valid)


class Bins(NamedTuple):
    gauss_id: torch.Tensor    # (E,) splat of each entry, by (tile, depth, splat)
    tile_start: torch.Tensor  # (n_tiles,)
    tile_count: torch.Tensor  # (n_tiles,)


def bin_tiles(prep: Prep, width: int, height: int, max_tiles: int) -> Bins:
    """Each valid splat in the first `max_tiles` tiles of its rectangle
    (row-major), sorted per tile by view depth, ties by splat index."""
    dev = prep.depth.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    center, radius = prep.center.detach(), prep.radius.detach()
    x0, y0, x1, y1 = tile_rect(center, radius, gx, gy)
    rw = (x1 - x0).long()
    counts = torch.where(prep.valid, rw * (y1 - y0).long(), 0).clamp(max=max_tiles)
    sid = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(sid.numel(), device=dev) - first[sid]
    w = rw.clamp(min=1)[sid]
    tid = (y0.long()[sid] + slot // w) * gx + x0.long()[sid] + slot % w
    dbits = prep.depth.detach().contiguous().view(torch.int32).to(torch.int64)[sid]
    _, order = torch.sort((tid << 32) | dbits, stable=True)
    tid = tid[order]
    n_tiles = gx * gy
    count = torch.bincount(tid, minlength=n_tiles)
    return Bins(sid[order], torch.cumsum(count, 0) - count, count)


def _composite(alpha, depth, rgb, normal, bg, ops: Ops, want_dist: bool):
    """Front-to-back compositing of (B, K, N) alphas; the loop's early stop
    as a mask, since T only falls."""
    stop = torch.cumprod(1.0 - alpha, dim=1) < T_EPS
    a = torch.where(stop, 0.0, alpha)
    cp = torch.cumprod(1.0 - a, dim=1)
    T_ex = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    w = a * T_ex
    final_T = cp[:, -1]
    out = {
        "color": ops.einsum("bkp,bkc->bpc", w, rgb) + final_T[..., None] * bg,
        "normal": ops.einsum("bkp,bkc->bpc", w, normal),
        "depth_acc": torch.sum(w * depth, dim=1),
        "final_T": final_T,
    }
    if want_dist:
        m = FAR / (FAR - NEAR) * (1.0 - NEAR / torch.clamp(depth, min=1e-8))
        mw, m2w = m * w, m * m * w
        M1 = torch.cumsum(mw, 1) - mw
        M2 = torch.cumsum(m2w, 1) - m2w
        out["distortion"] = torch.sum((m * m * (1.0 - T_ex) + M2 - 2.0 * m * M1) * w, dim=1)
    else:
        out["distortion"] = torch.zeros_like(final_T)
    contrib = a > 0.0
    kidx = torch.arange(alpha.shape[1], device=alpha.device)[None, :, None]
    best = torch.where((T_ex > 0.5) & contrib, kidx, -1).max(dim=1).values
    picked = torch.gather(depth, 1, best.clamp(min=0)[:, None]).squeeze(1)
    out["median_depth"] = torch.where(best >= 0, picked, 0.0)
    out["n_pairs"] = contrib.sum(dim=(1, 2))
    return out


MAP_KEYS = ("color", "normal", "depth_acc", "final_T", "distortion", "median_depth")


def _tile_block(tiles, K, bins, gx, bg, ops, want_dist, T, center, opacity, valid, rgb, normal):
    """Every map of the tiles `tiles`, each with up to K entries."""
    dev = T.device
    gid_all = bins.gauss_id if bins.gauss_id.numel() else torch.zeros(1, dtype=torch.long,
                                                                      device=dev)
    ks = torch.arange(K, device=dev)
    in_range = ks[None] < bins.tile_count[tiles][:, None]
    idx = torch.clamp(bins.tile_start[tiles][:, None] + ks, max=gid_all.numel() - 1)
    gid = gid_all[idx]                                                   # (B, K)
    ly, lx = torch.meshgrid(torch.arange(TILE, device=dev), torch.arange(TILE, device=dev),
                            indexing="ij")
    px = (lx.reshape(-1)[None] + ((tiles % gx) * TILE)[:, None]).to(torch.float32)
    py = (ly.reshape(-1)[None] + ((tiles // gx) * TILE)[:, None]).to(torch.float32)
    Tg = T[gid]                                                          # (B, K, 3, 3)
    x, y = px[:, None, :], py[:, None, :]                                # (B, 1, N)

    def row(r, c):
        return Tg[:, :, r, c][..., None]                                 # (B, K, 1)

    k0, k1, k2 = x * row(2, 0) - row(0, 0), x * row(2, 1) - row(0, 1), x * row(2, 2) - row(0, 2)
    l0, l1, l2 = y * row(2, 0) - row(1, 0), y * row(2, 1) - row(1, 1), y * row(2, 2) - row(1, 2)
    p0 = k1 * l2 - k2 * l1
    p1 = k2 * l0 - k0 * l2
    pz = k0 * l1 - k1 * l0
    safe = torch.where(torch.abs(pz) < 1e-20, 1.0, pz)
    su = torch.clamp(p0 / safe, -3e4, 3e4)
    sv = torch.clamp(p1 / safe, -3e4, 3e4)
    rho3d = su * su + sv * sv
    cg = center[gid]
    dx = cg[..., 0:1] - x
    dy = cg[..., 1:2] - y
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, su * row(2, 0) + sv * row(2, 1) + row(2, 2), row(2, 2))
    alpha = torch.clamp(opacity[gid][..., None] * torch.exp(-0.5 * rho), max=ALPHA_CLAMP)
    live = ((torch.abs(pz) >= 1e-20) & (depth >= NEAR) & (alpha >= ALPHA_EPS)
            & (valid[gid] & in_range)[..., None])
    alpha = torch.where(live, alpha, 0.0)
    out = _composite(alpha, depth, rgb[gid], normal[gid], bg, ops, want_dist)
    return tuple(out[k] for k in MAP_KEYS) + (out["n_pairs"],)


def rasterize(prep: Prep, bins: Bins, width: int, height: int, bg: torch.Tensor, ops: Ops,
              want_dist: bool, block_pairs: int = BLOCK_PAIRS):
    """(H, W, ...) maps and the contributing (pixel, splat) pairs of each
    tile. Tiles run in blocks of similar length, under checkpoint when
    gradients are on."""
    dev = prep.depth.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    n_tiles = gx * gy
    order = torch.argsort(bins.tile_count, stable=True)
    counts = bins.tile_count[order].tolist()
    fields = (prep.T, prep.center, prep.opacity, prep.valid, prep.rgb, prep.normal)
    parts, i = [], 0
    while i < n_tiles:
        j = i + 1
        while j < n_tiles and (j + 1 - i) * max(counts[j], 1) * TILE * TILE <= block_pairs:
            j += 1
        tiles, K = order[i:j], max(counts[j - 1], 1)
        args = (tiles, K, bins, gx, bg, ops, want_dist) + fields
        if torch.is_grad_enabled():
            parts.append(checkpoint(_tile_block, *args, use_reentrant=False))
        else:
            parts.append(_tile_block(*args))
        i = j
    inv = torch.argsort(order)
    maps = {}
    for n, key in enumerate(MAP_KEYS + ("n_pairs",)):
        flat = torch.cat([p[n] for p in parts])[inv]                 # (n_tiles, 256, ...)
        if key == "n_pairs":
            maps[key] = flat
            continue
        ch = flat.shape[2:]
        img = flat.reshape((gy, gx, TILE, TILE) + ch).transpose(1, 2)
        maps[key] = img.reshape((gy * TILE, gx * TILE) + ch)[:height, :width]
    maps["alpha"] = 1.0 - maps["final_T"]
    return maps


def depth_to_normal(cam: Cam, depth: torch.Tensor, ops: Ops) -> torch.Tensor:
    """(H, W) view depth → (H, W, 3) world normals from central differences
    of the back-projected points, zero on the border."""
    H, W = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    dirs = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, torch.ones_like(xs)], -1)
    pts = cam_center(cam) + depth[..., None] * ops.matmul(dirs, cam.w2c[:3, :3])
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = normalize(torch.linalg.cross(dx, dy))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def render(cam: Cam, scene: Dict[str, torch.Tensor], sh_degree: int, ops: Ops,
           depth_ratio: float = 0.0, max_tiles: int = 16, want_dist: bool = True,
           bg=(0.0, 0.0, 0.0)) -> Dict[str, torch.Tensor]:
    """The wrapper's outputs (gaussian_renderer/__init__.py:117-164) for
    `scene` = {xyz, features, opacity (P,), scaling (P, 2), rotation_raw}.
    Also returns `n_pairs`, the contributing pairs of each tile."""
    prep = preprocess(cam, scene["xyz"], scene["scaling"], scene["rotation_raw"],
                      scene["opacity"], scene["features"], sh_degree, ops,
                      scene.get("center_offset"))
    bins = bin_tiles(prep, cam.width, cam.height, max_tiles)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=cam.w2c.device)
    maps = rasterize(prep, bins, cam.width, cam.height, bg, ops, want_dist)
    alpha = maps["alpha"]
    R_c2w = cam.w2c[:3, :3].T
    depth_exp = torch.nan_to_num(maps["depth_acc"] / torch.clamp(alpha, min=1e-10))
    surf_depth = (depth_exp * (1.0 - depth_ratio)
                  + depth_ratio * torch.nan_to_num(maps["median_depth"]))
    return {
        "render": maps["color"],
        "rend_alpha": alpha,
        "rend_normal": ops.matmul(maps["normal"], R_c2w.T),
        "rend_dist": maps["distortion"],
        "surf_depth": surf_depth,
        "surf_normal": depth_to_normal(cam, surf_depth, ops) * alpha.detach()[..., None],
        "radii": prep.radius,
        "n_pairs": maps["n_pairs"],
        "n_entries": bins.gauss_id.numel(),
    }
