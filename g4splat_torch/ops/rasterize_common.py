"""Shared machinery for all surfel-rasterizer backends (counterpart of
`g4splat_tpu.ops.rasterize_common`).

Math follows the 2DGS surfel formulation of the reference CUDA rasterizer
(diff-surfel-rasterization/cuda_rasterizer/forward.cu) in column-vector form:

- A surfel's local (u, v) maps to world ``c + u·s1·r1 + v·s2·r2``; composing
  the 4x3 splat2world matrix S with the 3x4 world→homogeneous-pixel matrix M
  gives ``T = M @ S``, mapping (u, v, 1) → (x·w, y·w, w) (forward.cu:75-115).
- Ray-splat intersection solves two homogeneous plane equations
  (k = x·Tw − Tu, l = y·Tw − Tv, s = cross(k, l)) (forward.cu:352-366).
- Screen-space AABB/center from the dual conic (forward.cu:119-147).
- Object-space falloff is min'd with a screen-space low-pass filter of inverse
  variance 2 (auxiliary.h:39).
- Front-to-back compositing with a 0.99 alpha clamp, 1/255 alpha cutoff and a
  1e-4 transmittance early-out (forward.cu:377-389).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Union

import torch

from g4splat_torch.core import sh as sh_lib
from g4splat_torch.core.cameras import Camera
from g4splat_torch.core.transforms import normalize, quat_to_rotmat
from g4splat_torch.utils.profiling import annotate

# Reference constants (auxiliary.h:18,37-39; config.h:15-17)
TILE = 16
NEAR_N = 0.2
FAR_N = 100.0
FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_CLAMP = 0.99
CUTOFF = 3.0  # Gaussian support cutoff in σ
# The CUDA kernels' entry table: (E, 16) float32, one 64-byte row per entry
# (0-8 T rows Tu, Tv, Tw; 9 opacity, 0 for culled splats; 10-12 rgb; 13-15
# view-space normal). The low-pass centre is recomputed from T.
ENTRY_F = 16


@dataclass(frozen=True)
class RenderConfig:
    bg: Union[Sequence[float], torch.Tensor] = (0.0, 0.0, 0.0)
    scale_modifier: float = 1.0
    depth_ratio: float = 0.0
    near: float = NEAR_N
    far: float = FAR_N
    # `tiled` backend only: front-most entries composited per tile. The CUDA
    # kernel and its plain version have no such cap.
    tile_k: int = 1024
    # Per-splat candidate-tile cap for binning (overflow counted in n_dropped).
    max_tiles_per_splat: int = 16
    # Exact ellipse-level tile pruning in binning (rasterize_tiled._ellipse_keep).
    tile_ellipse_prune: bool = True
    # Compute the distortion channel (rend_dist, dist_m1, dist_m2) in the
    # CUDA kernel; when False those maps are zeros.
    compute_distortion: bool = True
    # Accepted for config compatibility with the JAX package and ignored: the
    # port always sorts on exact depth into an exactly sized entry list, so
    # the TPU's sort-saving layouts have no counterpart.
    depth_rank_binning: bool = False
    buf_factor: int = 4
    buf_size: int = 0
    binning_compact_width: int = 8


@dataclass(frozen=True)
class Preprocessed:
    """Per-splat screen-space quantities (all shape (P, …))."""
    T: torch.Tensor           # (P, 3, 3) rows = Tu, Tv, Tw
    center: torch.Tensor      # (P, 2) low-pass filter center, pixels
    radius: torch.Tensor      # (P,) screen radius, pixels
    depth: torch.Tensor       # (P,) view-space z of the splat center
    normal: torch.Tensor      # (P, 3) view-space normal (camera-facing)
    opacity: torch.Tensor     # (P,)
    rgb: torch.Tensor         # (P, 3)
    valid: torch.Tensor       # (P,) bool — frustum & extent culling

    def index(self, idx) -> "Preprocessed":
        """Gather every field along the splat axis."""
        return Preprocessed(**{f.name: getattr(self, f.name)[idx]
                               for f in dataclasses.fields(self)})


def float_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncating float→int32 with XLA's convert semantics (NaN → 0,
    saturating at the int32 range), so degenerate splats bin as in JAX."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2147483520.0, 2147483520.0)
    return x.to(torch.int32)


def tile_rect(center: torch.Tensor, radius: torch.Tensor, gx: int, gy: int):
    """Tile-rect bounds [rmin, rmax) of each splat's ±radius AABB (getRect,
    auxiliary.h)."""
    rmin_x = float_to_int32((center[:, 0] - radius) / TILE).clamp(0, gx)
    rmin_y = float_to_int32((center[:, 1] - radius) / TILE).clamp(0, gy)
    rmax_x = float_to_int32((center[:, 0] + radius + TILE - 1) / TILE).clamp(0, gx)
    rmax_y = float_to_int32((center[:, 1] + radius + TILE - 1) / TILE).clamp(0, gy)
    return rmin_x, rmin_y, rmax_x, rmax_y


def conic_center(T: torch.Tensor):
    """Screen centre of each splat's dual conic (compute_aabb,
    forward.cu:119-147) from its (..., 3, 3) T. Returns (center (..., 2),
    f (..., 3), ok (...)): f scales the conic, ok is False where the conic is
    degenerate (and f unscaled there)."""
    Tu, Tv, Tw = T[..., 0, :], T[..., 1, :], T[..., 2, :]
    with annotate("g4s:sync.conic"):
        tmp = T.new_tensor([CUTOFF * CUTOFF, CUTOFF * CUTOFF, -1.0])
    dist = torch.sum(Tw * Tw * tmp, dim=-1)
    ok = torch.abs(dist) > 1e-12
    f = tmp / torch.where(ok, dist, 1.0)[..., None]
    center = torch.stack(
        [torch.sum(f * Tu * Tw, dim=-1), torch.sum(f * Tv * Tw, dim=-1)], dim=-1)
    return center, f, ok


def preprocess(
    camera: Camera,
    xyz: torch.Tensor,
    scaling: torch.Tensor,
    rotation_raw: torch.Tensor,
    opacity: torch.Tensor,
    features: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    colors: Optional[torch.Tensor] = None,
    config: Optional[RenderConfig] = None,
    center_offset: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Vectorized splat preprocess (reference preprocessCUDA,
    forward.cu:151-253). `center_offset` is a (P, 2) zeros tensor whose
    gradient is the screen-space positional gradient used for densification."""
    config = config or RenderConfig()
    P = xyz.shape[0]

    R_w2c = camera.w2c[:3, :3]
    t_w2c = camera.w2c[:3, 3]
    p_view = xyz @ R_w2c.T + t_w2c
    in_front = p_view[:, 2] >= 0.2

    # splat2world (P, 4, 3): columns [s1·r1, 0], [s2·r2, 0], [c, 1].
    R = quat_to_rotmat(rotation_raw)
    s = scaling * config.scale_modifier
    ax_u = R[..., :, 0] * s[:, 0:1]
    ax_v = R[..., :, 1] * s[:, 1:2]
    zeros = xyz.new_zeros((P, 1))
    ones = xyz.new_ones((P, 1))
    S = torch.stack(
        [torch.cat([ax_u, zeros], 1), torch.cat([ax_v, zeros], 1),
         torch.cat([xyz, ones], 1)],
        dim=-1,
    )
    # T[p] = M @ S[p]: rows Tu, Tv, Tw (x·w, y·w, w), columns (u, v, 1).
    T = torch.einsum("ij,pjk->pik", camera.world2pix, S)

    # View-space normal with camera-facing flip (forward.cu:211-216).
    normal_view = R[..., :, 2] @ R_w2c.T
    cos = -torch.sum(p_view * normal_view, dim=-1)
    normal_view = normal_view * torch.where(cos > 0, 1.0, -1.0)[:, None]

    # Screen AABB via the dual conic (compute_aabb, forward.cu:119-147).
    Tu, Tv = T[:, 0], T[:, 1]
    center, f, ok = conic_center(T)
    if center_offset is not None:
        center = center + center_offset
    half_sq = center * center - torch.stack(
        [torch.sum(f * Tu * Tu, dim=-1), torch.sum(f * Tv * Tv, dim=-1)], dim=-1)
    extent = torch.sqrt(torch.clamp(half_sq, min=1e-4))
    radius = torch.ceil(torch.max(extent, dim=-1).values)

    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    rmin_x, rmin_y, rmax_x, rmax_y = tile_rect(center, radius, gx, gy)
    nonempty = ((rmax_x - rmin_x) * (rmax_y - rmin_y)) > 0

    if colors is None:
        dirs = normalize(xyz - camera.center)
        colors = sh_lib.sh_to_rgb(sh_degree, features, dirs)

    # Cull zero-opacity splats (dead slots, fully transparent splats): their
    # alpha is below 1/255 everywhere (forward.cu:381-383).
    valid = in_front & ok & nonempty & (opacity.reshape(-1) >= ALPHA_EPS)
    center = torch.where(valid[:, None], center, 0.0)
    return Preprocessed(
        T=T,
        center=center,
        radius=torch.where(valid, radius, 0.0),
        depth=p_view[:, 2],
        normal=normal_view,
        opacity=opacity.reshape(-1),
        rgb=colors,
        valid=valid,
    )


class RaySplat(NamedTuple):
    """The ray-splat terms of every (splat, pixel) pair, shape (..., K, N[, 3])."""
    k: torch.Tensor           # x·Tw − Tu
    l: torch.Tensor           # y·Tw − Tv
    pz: torch.Tensor          # (k × l)_z
    safe_pz: torch.Tensor     # pz, 1 where |pz| < 1e-20
    su_raw: torch.Tensor      # intersection (u, v) before the clamp
    sv_raw: torch.Tensor
    su: torch.Tensor
    sv: torch.Tensor
    dx: torch.Tensor          # centre − pixel
    dy: torch.Tensor
    use3d: torch.Tensor       # rho3d ≤ rho2d
    rho: torch.Tensor
    depth: torch.Tensor


def ray_splat(T, center, px, py) -> RaySplat:
    """Ray-splat intersection and low-pass terms (forward.cu:352-375).

    T (..., K, 3, 3), center (..., K, 2); px, py (..., N) pixel coordinates.
    """
    Tu = T[..., :, None, 0, :]        # (..., K, 1, 3)
    Tv = T[..., :, None, 1, :]
    Tw = T[..., :, None, 2, :]
    x = px[..., None, :, None]        # (..., 1, N, 1)
    y = py[..., None, :, None]
    k = x * Tw - Tu
    l = y * Tw - Tv
    p = torch.linalg.cross(k, l)      # (..., K, N, 3)
    pz = p[..., 2]
    safe_pz = torch.where(torch.abs(pz) < 1e-20, 1.0, pz)
    # Clamp the intersection coordinates: grazing splats give huge |s| whose
    # square overflows f32 and turns gradients into inf·0 = NaN. exp(-0.5·ρ)
    # is already 0 far below the clamp, so results are unchanged.
    su_raw = p[..., 0] / safe_pz
    sv_raw = p[..., 1] / safe_pz
    su = torch.clamp(su_raw, -3e4, 3e4)
    sv = torch.clamp(sv_raw, -3e4, 3e4)
    rho3d = su * su + sv * sv
    dx = center[..., :, None, 0] - px[..., None, :]
    dy = center[..., :, None, 1] - py[..., None, :]
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, su * Tw[..., 0] + sv * Tw[..., 1] + Tw[..., 2],
                        Tw[..., 2])
    return RaySplat(k, l, pz, safe_pz, su_raw, sv_raw, su, sv, dx, dy, use3d, rho, depth)


def alpha_depth(T, center, opacity, valid, px, py, near: float = NEAR_N):
    """Per-(splat, pixel) alpha and intersection depth (forward.cu:352-389).

    T (..., K, 3, 3), center (..., K, 2), opacity and valid (..., K); px, py
    (..., N) pixel coordinates. Returns alpha, depth of shape (..., K, N).
    """
    r = ray_splat(T, center, px, py)
    alpha = torch.clamp(opacity[..., :, None] * torch.exp(-0.5 * r.rho), max=ALPHA_CLAMP)
    live = ((torch.abs(r.pz) >= 1e-20) & (r.depth >= near) & (alpha >= ALPHA_EPS)
            & valid[..., :, None])
    return torch.where(live, alpha, 0.0), r.depth


def splat_alpha_depth(prep: Preprocessed, px: torch.Tensor, py: torch.Tensor,
                      near: float = NEAR_N):
    """Per-(splat, pixel) alpha and depth for flat pixel lists: (P, N)."""
    return alpha_depth(prep.T, prep.center, prep.opacity, prep.valid, px, py, near)
