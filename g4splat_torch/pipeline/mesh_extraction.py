"""Gaussian-adaptive tetrahedral mesh extraction (counterpart of
`g4splat_tpu.pipeline.mesh_extraction`).

The reference's marching tetrahedra with binary search
(2d-gaussian-splatting/extract_mesh_adaptive_tsdf.py:219-383,
scripts/extract_tetra_mesh.py):

  tetra candidate points from the splats (8 corners + centre,
  gaussian_model.py:318-382) → Delaunay cells (host) → every view rendered
  once by `render` and its maps kept on the device → adaptive TSDF at the
  tetra vertices → marching tetrahedra (host) → binary search along the
  crossing edges, re-evaluating the TSDF at the midpoints → vertex colours
  from SH-degree-0 renders.

As in the JAX package the scene is frozen during extraction, so each view is
rendered once and its maps serve every TSDF evaluation (the reference
re-renders inside each one). The render backend defaults to "cuda" (kernel
B1); on CPU tensors it runs B1's plain version, and it never falls back from
one to the other. Everything runs on the scene's device; Delaunay, marching
and the cluster filter are host numpy/scipy, as in the JAX package.

Defaults follow configs/adaptive_tetrahedralization/default.yaml
(gaussian_flatness 2e-4, depth_ratio 1.0, truncation_margin 0.005·extent).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from g4splat_torch.core.cameras import (
    Camera,
    camera_at,
    interpolate_cameras,
    project_points,
    stack_cameras,
)
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.ops.tetra import (
    cube_grid_to_tets,
    delaunay_tetrahedralize,
    marching_tetrahedra,
)
from g4splat_torch.ops.tsdf import (
    TSDFConfig,
    apply_sdf_tolerance,
    dilate_depth_along_normals,
    integrate_views_chunked,
)


@dataclass(frozen=True)
class MeshExtractionConfig:
    downsample_ratio: float = 0.25
    gaussian_flatness: float = 2e-4
    depth_ratio: float = 1.0
    truncation_margin: float = 0.005        # × camera spatial extent
    n_binary_steps: int = 8
    interpolate_depth: bool = True
    interpolation_mode: str = "bilinear"    # 'bilinear' | 'nearest'
    weight_interpolation_by_depth_gradient: bool = False
    use_binary_opacity: bool = False
    unbias_depth_using_normals: bool = False
    filter_with_depth_gradient: bool = False
    filter_with_normal_consistency: bool = False
    weight_by_normal_consistency: bool = False
    weight_by_softmax: bool = False
    softmax_temperature: float = 1.0
    # Depth preprocessing before TSDF integration
    # (extract_mesh_adaptive_tsdf.py:168-184; 1.5 px, at most 1e-3 × extent).
    use_dilated_depth: bool = False
    use_sdf_tolerance: bool = False
    texture_mesh: bool = True
    backend: str = "cuda"
    point_chunk: int = 262_144
    # Interpolated viewpoints between input cameras
    # (extract_mesh_adaptive_tsdf.py:441-451; configs: 2 neighbours, 10 each).
    use_interpolated_views: bool = False
    interp_neighbors: int = 2
    interp_per_neighbor: int = 10

    def replace(self, **kw) -> "MeshExtractionConfig":
        return dataclasses.replace(self, **kw)


# The orchestrator's extraction config (orchestrator.py:1531-1538):
# tetra_downsample_ratio 0.5 and interpolated views on, over
# configs/adaptive_tetrahedralization/default.yaml, whose values all equal the
# dataclass defaults above (its `filter_mesh` names no field).
PRODUCTION_MESH_CONFIG = MeshExtractionConfig(downsample_ratio=0.5,
                                              use_interpolated_views=True)

# Reference key names (configs/adaptive_tetrahedralization/*.yaml) →
# MeshExtractionConfig fields, as the orchestrator maps them (:1520-1530).
REFERENCE_KEYS = (
    ("use_unbiased_tsdf", "unbias_depth_using_normals"),
    ("n_neighbors_to_interpolate", "interp_neighbors"),
    ("n_interpolated_cameras_for_each_neighbor", "interp_per_neighbor"),
)


def mesh_config_from(overrides: Dict[str, Any],
                     base: Optional[MeshExtractionConfig] = None) -> MeshExtractionConfig:
    """A MeshExtractionConfig from a dict of the adaptive-tetrahedralization
    config's keys (reference names mapped onto the fields; keys that name no
    field, such as `filter_mesh`, are ignored), over `base`."""
    base = base or MeshExtractionConfig()
    cfg = dict(overrides)
    for src, dst in REFERENCE_KEYS:
        if src in cfg:
            cfg[dst] = cfg.pop(src)
    fields = {f.name for f in dataclasses.fields(MeshExtractionConfig)}
    return base.replace(**{k: v for k, v in cfg.items() if k in fields})


class ExtractedMesh(NamedTuple):
    vertices: np.ndarray                 # (V, 3) float32
    faces: np.ndarray                    # (F, 3)
    vertex_colors: Optional[np.ndarray]  # (V, 3) float in [0, 1], or None


class RenderedViews(NamedTuple):
    """Stacked (V, H, W[, 3]) maps of `render_all_views`, on the scene's device."""
    rgbs: torch.Tensor
    depths: torch.Tensor
    surf_normals: torch.Tensor
    rend_normals: torch.Tensor
    alphas: torch.Tensor


def cameras_spatial_extent(cameras: Camera) -> float:
    """Largest distance of a camera centre from their mean
    (matcha/dm_scene/cameras.py:854-867)."""
    centers = cameras.center.detach().cpu().numpy()
    avg = centers.mean(0, keepdims=True)
    return float(np.linalg.norm(centers - avg, axis=-1).max())


def render_all_views(scene: GaussianScene, cameras: Camera, depth_ratio: float,
                     backend: str = "cuda", sh_degree: Optional[int] = None
                     ) -> RenderedViews:
    """Render every camera once with `render`'s full maps and no distortion
    (nothing in mesh extraction reads it): one B1 launch per camera on the
    cuda backend. `surf_depth` is the median depth at depth_ratio 1."""
    s = scene if sh_degree is None else scene.replace(active_sh_degree=sh_degree)
    cfg = RenderConfig(bg=(0.0, 0.0, 0.0), depth_ratio=depth_ratio,
                       compute_distortion=False)
    keys = ("render", "surf_depth", "surf_normal", "rend_normal", "rend_alpha")
    maps = {k: [] for k in keys}
    with torch.no_grad():
        for i in range(cameras.w2c.shape[0]):
            out = render(camera_at(cameras, i), s, config=cfg, backend=backend)
            for k in keys:
                maps[k].append(out[k])
    return RenderedViews(*(torch.stack(maps[k]) for k in keys))


def with_interpolated_views(cameras: Camera, config: MeshExtractionConfig) -> Camera:
    """The cameras the extraction renders: the inputs, then (with
    use_interpolated_views) the interpolated ones."""
    if not config.use_interpolated_views:
        return cameras
    interp = interpolate_cameras(cameras, config.interp_neighbors,
                                 config.interp_per_neighbor)
    return stack_cameras([camera_at(cameras, i) for i in range(cameras.w2c.shape[0])]
                         + [camera_at(interp, i) for i in range(interp.w2c.shape[0])])


def tsdf_config(config: MeshExtractionConfig, extent: float) -> TSDFConfig:
    """The TSDF options of an extraction config at this camera extent."""
    return TSDFConfig(
        trunc_margin=config.truncation_margin * extent,
        use_binary_opacity=config.use_binary_opacity,
        interpolate_depth=config.interpolate_depth,
        interpolation_mode=config.interpolation_mode,
        weight_interpolation_by_depth_gradient=config.weight_interpolation_by_depth_gradient,
        depth_gradient_threshold=0.2 * extent,
        filter_with_depth_gradient=config.filter_with_depth_gradient,
        depth_gradient_threshold_for_filtering=0.1 * extent,
        unbias_depth_using_normals=config.unbias_depth_using_normals,
        filter_with_normal_consistency=config.filter_with_normal_consistency,
        normal_consistency_threshold=0.5,
        weight_by_normal_consistency=config.weight_by_normal_consistency,
        weight_by_softmax=config.weight_by_softmax,
        softmax_temperature=config.softmax_temperature,
    )


def extract_mesh_adaptive_tsdf(
    scene: GaussianScene,
    cameras: Camera,
    config: MeshExtractionConfig = MeshExtractionConfig(),
    seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
) -> ExtractedMesh:
    """The adaptive tetra mesh. `timings`, when given, receives the seconds
    of each stage (host clock; device stages end in a synchronize)."""
    clock = _Clock(timings, scene.device)
    extent = cameras_spatial_extent(cameras)
    cameras = with_interpolated_views(cameras, config)
    tsdf_cfg = tsdf_config(config, extent)

    # 1. Tetra candidate points + Delaunay cells (host).
    points, point_scales = scene.tetra_points(
        downsample_ratio=config.downsample_ratio,
        flatness=config.gaussian_flatness * extent, seed=seed)
    clock("tetra_points")
    cells = delaunay_tetrahedralize(points)
    clock("delaunay")

    # 2. Render every view once; its maps stay on the device.
    views = render_all_views(scene, cameras, config.depth_ratio, config.backend)
    rgbs, depths = views.rgbs, views.depths
    clock("render_all_views")
    if config.use_dilated_depth:
        dd, rr = zip(*(dilate_depth_along_normals(
            camera_at(cameras, i), depths[i], rgbs[i], dilation_px=1.5,
            max_dilation=1e-3 * extent) for i in range(cameras.w2c.shape[0])))
        depths, rgbs = torch.stack(dd), torch.stack(rr)
    if config.use_sdf_tolerance:
        focals = (cameras.fx + cameras.fy) / 2.0
        depths = apply_sdf_tolerance(depths, focals[:, None, None], tolerance_px=1.5,
                                     max_tolerance=1e-3 * extent)
    need_normals = (config.unbias_depth_using_normals
                    or config.filter_with_normal_consistency
                    or config.weight_by_normal_consistency)
    need_ref = config.filter_with_normal_consistency or config.weight_by_normal_consistency

    def eval_tsdf(pts):
        return integrate_views_chunked(
            pts, cameras, rgbs, depths, tsdf_cfg,
            normals=views.surf_normals if need_normals else None,
            reference_normals=views.rend_normals if need_ref else None,
            chunk=config.point_chunk)

    # 3. TSDF at the tetra vertices → marching tetrahedra (host).
    sdf0 = eval_tsdf(points).tsdf.cpu().numpy()
    clock("tsdf")
    mt = marching_tetrahedra(points, cells, sdf0, point_scales)
    clock("marching")

    # 4. Binary search along the crossing edges, re-evaluating the TSDF
    # (extract_mesh_adaptive_tsdf.py:328-351), on the device.
    dev = depths.device
    left = torch.as_tensor(mt.edge_verts[:, 0], device=dev)
    right = torch.as_tensor(mt.edge_verts[:, 1], device=dev)
    left_sdf = torch.as_tensor(mt.edge_sdf[:, 0], device=dev)
    for step in range(config.n_binary_steps):
        mid = (left + right) / 2.0
        mid_sdf = eval_tsdf(mid).tsdf
        same_side = ((mid_sdf < 0) & (left_sdf < 0)) | ((mid_sdf > 0) & (left_sdf > 0))
        left = torch.where(same_side[:, None], mid, left)
        left_sdf = torch.where(same_side, mid_sdf, left_sdf)
        right = torch.where(same_side[:, None], right, mid)
        clock(f"binary_step_{step}")
    verts = (left + right) / 2.0

    # 5. Vertex colours from SH-degree-0 renders (:353-364).
    colors = None
    if config.texture_mesh:
        views0 = render_all_views(scene, cameras, config.depth_ratio, config.backend,
                                  sh_degree=0)
        clock("render_all_views_sh0")
        colors = torch.clamp(eval_tsdf_colors(verts, cameras, views0.rgbs, views0.depths,
                                              tsdf_cfg, config.point_chunk), 0.0, 1.0)
        colors = colors.cpu().numpy()
        clock("colors")
    return ExtractedMesh(verts.cpu().numpy().astype(np.float32), mt.faces, colors)


class _Clock:
    """Stage timer: each call records the seconds since the previous one,
    after a device synchronize. Does nothing without a dict to fill."""

    def __init__(self, timings: Optional[Dict[str, float]], device: torch.device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def __call__(self, stage: str):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + (t - self.t)
        self.t = t


def eval_tsdf_colors(pts, cameras, rgbs, depths, tsdf_cfg, chunk) -> torch.Tensor:
    return integrate_views_chunked(pts, cameras, rgbs, depths, tsdf_cfg, chunk=chunk).colors


def keep_largest_clusters(mesh: ExtractedMesh, cluster_to_keep: int = 50,
                          min_triangles: int = 50) -> ExtractedMesh:
    """Floater removal (2dgs/utils/mesh_utils.py:22-41 post_process_mesh):
    cluster edge-connected triangles, keep the clusters at least as large as
    the `cluster_to_keep`-th biggest (and at least min_triangles), drop the
    rest and compact unreferenced vertices. Meshes of at most min_triangles
    faces are returned whole."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    faces = np.asarray(mesh.faces)
    F = len(faces)
    if F <= min_triangles:
        return mesh
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    fidx = np.tile(np.arange(F), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e, fidx = e[order], fidx[order]
    same = (e[1:] == e[:-1]).all(axis=1)
    rows, cols = fidx[:-1][same], fidx[1:][same]
    adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(F, F))
    n_comp, labels = connected_components(adj, directed=False)
    counts = np.bincount(labels, minlength=n_comp)
    kth = np.sort(counts)[-min(cluster_to_keep, n_comp)]
    thr = max(kth, min_triangles)
    faces = faces[counts[labels] >= thr]
    used = np.unique(faces)
    remap = np.full(len(mesh.vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    return ExtractedMesh(
        mesh.vertices[used], remap[faces].astype(np.int32),
        mesh.vertex_colors[used] if mesh.vertex_colors is not None else None)


def filter_mesh_by_edge_length(mesh: ExtractedMesh,
                               length_threshold: float = 0.5) -> ExtractedMesh:
    """Drop faces with an edge of at least `length_threshold` (forward-facing
    scenes; utils/mesh_filter.py, train.py:352-366; the JAX package's
    orchestrator.py:1778-1792)."""
    v, f = mesh.vertices, mesh.faces
    e = np.stack([
        np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=1),
        np.linalg.norm(v[f[:, 1]] - v[f[:, 2]], axis=1),
        np.linalg.norm(v[f[:, 2]] - v[f[:, 0]], axis=1),
    ], 1)
    return ExtractedMesh(mesh.vertices, f[e.max(1) < length_threshold], mesh.vertex_colors)


def _verts_covered(cameras: Camera, verts: np.ndarray, depth_trunc: float) -> np.ndarray:
    """(n_verts,) True where some camera sees the vertex in its frustum and
    closer than depth_trunc (render_multires.py:163-180)."""
    covered = torch.zeros(len(verts), dtype=torch.bool, device=cameras.device)
    vt = torch.as_tensor(np.asarray(verts, np.float32), device=cameras.device)
    W, H = int(cameras.width), int(cameras.height)
    world2pix = cameras.world2pix
    for i in range(cameras.w2c.shape[0]):
        xy, z = project_points(world2pix[i], vt)
        in_img = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H) & (z > 0)
        covered |= in_img & (z < depth_trunc)
    return covered.cpu().numpy()


def _grid(lo, hi, resolution: int):
    xs, ys, zs = (np.linspace(lo[i], hi[i], resolution) for i in range(3))
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.float32)


def _live_bounds(scene: GaussianScene):
    pts = scene.xyz[scene.alive].detach().cpu().numpy()
    lo = pts.min(0) - 0.05 * (pts.max(0) - pts.min(0))
    hi = pts.max(0) + 0.05 * (pts.max(0) - pts.min(0))
    return lo, hi


def _interpolated_crossings(mt):
    s0 = np.abs(mt.edge_sdf[:, 0])
    s1 = np.abs(mt.edge_sdf[:, 1])
    w = (s0 / np.maximum(s0 + s1, 1e-12))[:, None]
    return (mt.edge_verts[:, 0] * (1 - w) + mt.edge_verts[:, 1] * w).astype(np.float32)


def extract_mesh_multires_tsdf(
    scene: GaussianScene,
    cameras: Camera,
    factors: Sequence[float] = (2.0, 8.0, 16.0),
    resolution: int = 128,
    mesh_res: int = 1024,
    depth_ratio: float = 1.0,
    backend: str = "cuda",
    point_chunk: int = 262_144,
    timings: Optional[Dict[str, float]] = None,
) -> ExtractedMesh:
    """Multi-resolution TSDF mesh merge (render_multires.py:97-206).

    Per factor f: depth_trunc = camera extent · f and sdf_trunc = 5 ·
    depth_trunc / mesh_res (open3d's parameters, at least one lattice cell);
    depths beyond depth_trunc are zeroed as open3d's depth_trunc does. Level
    i > 0 drops the faces whose vertices all lie in some camera's frustum
    closer than level i−1's depth_trunc. As in the JAX package, open3d's
    voxel hash is a dense `resolution`³ lattice shared by the levels, cut
    into 6 tets per cell for marching tetrahedra."""
    clock = _Clock(timings, scene.device)
    extent = max(cameras_spatial_extent(cameras), 1e-6)
    lo, hi = _live_bounds(scene)
    grid_pts = _grid(lo, hi, resolution)
    cell = float((hi - lo).max() / (resolution - 1))
    _, tets = cube_grid_to_tets((resolution, resolution, resolution))
    # SH degree 0: diffuse texture only (render_multires.py:100-101).
    views = render_all_views(scene, cameras, depth_ratio, backend, sh_degree=0)
    clock("multires_render")

    meshes, depth_truncs = [], []
    for f in factors:
        depth_trunc = extent * float(f)
        sdf_trunc = max(5.0 * depth_trunc / mesh_res, cell)
        d = torch.where(views.depths <= depth_trunc, views.depths, 0.0)
        tsdf_cfg = TSDFConfig(trunc_margin=sdf_trunc)
        out = integrate_views_chunked(grid_pts, cameras, views.rgbs, d, tsdf_cfg,
                                      chunk=point_chunk)
        sdf, observed = out.tsdf.cpu().numpy(), (out.weights > 0).cpu().numpy()
        mt = marching_tetrahedra(grid_pts, tets, sdf,
                                 np.full(len(grid_pts), cell, np.float32))
        # open3d extracts surface only where voxels were observed; crossings
        # into never-observed space are phantom silhouette shells.
        bad_edge = ~observed[mt.edges].all(axis=1)
        mt = mt._replace(faces=mt.faces[~bad_edge[mt.faces].any(axis=1)])
        verts = _interpolated_crossings(mt)
        colors = (torch.clamp(eval_tsdf_colors(verts, cameras, views.rgbs, d, tsdf_cfg,
                                               point_chunk), 0, 1).cpu().numpy()
                  if len(verts) else np.zeros((0, 3), np.float32))
        meshes.append(ExtractedMesh(verts, mt.faces, colors))
        depth_truncs.append(depth_trunc)
        clock(f"multires_level_{f:g}")

    all_v, all_f, all_c = [], [], []
    offset = 0
    for i, mesh in enumerate(meshes):
        faces = mesh.faces
        if i > 0 and len(faces):
            non_valid = _verts_covered(cameras, mesh.vertices, depth_truncs[i - 1])
            faces = faces[~non_valid[faces].all(axis=1)]
        if len(faces) == 0:
            continue
        all_v.append(mesh.vertices)
        all_f.append(faces + offset)
        all_c.append(mesh.vertex_colors)
        offset += len(mesh.vertices)
    clock("multires_merge")
    if not all_v:
        return ExtractedMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                             np.zeros((0, 3), np.float32))
    return ExtractedMesh(np.concatenate(all_v), np.concatenate(all_f).astype(np.int32),
                         np.concatenate(all_c))


def extract_mesh_grid_tsdf(
    scene: GaussianScene,
    cameras: Camera,
    resolution: int = 128,
    depth_ratio: float = 1.0,
    trunc_voxels: float = 4.0,
    backend: str = "cuda",
    bounds: Optional[np.ndarray] = None,
    point_chunk: int = 262_144,
    carve_empty: bool = False,
) -> ExtractedMesh:
    """Uniform voxel-grid TSDF fusion + marching tetrahedra with linear
    crossings (render_multires.py:97-206 and utils/mesh_utils.py:140-184
    without open3d). With carve_empty, pixels of alpha <= 0.05 count as a
    far surface, so free space at the silhouette is carved out."""
    if bounds is None:
        lo, hi = _live_bounds(scene)
    else:
        lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
    points = _grid(lo, hi, resolution)
    voxel = float((hi - lo).max() / (resolution - 1))
    _, tets = cube_grid_to_tets((resolution, resolution, resolution))
    views = render_all_views(scene, cameras, depth_ratio, backend)
    depths = views.depths
    if carve_empty:
        far = 10.0 * float(np.linalg.norm(hi - lo))
        depths = torch.where(views.alphas > 0.05, depths, far)
    tsdf_cfg = TSDFConfig(trunc_margin=trunc_voxels * voxel)
    out = integrate_views_chunked(points, cameras, views.rgbs, depths, tsdf_cfg,
                                  chunk=point_chunk)
    # Unobserved points stay at −1 (outside), as open3d leaves them.
    mt = marching_tetrahedra(points, tets, out.tsdf.cpu().numpy(),
                             np.full(len(points), voxel, np.float32))
    verts = _interpolated_crossings(mt)
    colors = torch.clamp(eval_tsdf_colors(verts, cameras, views.rgbs, depths, tsdf_cfg,
                                          point_chunk), 0, 1).cpu().numpy()
    return ExtractedMesh(verts, mt.faces, colors)
