"""Public rendering API (counterpart of `g4splat_tpu.ops.rasterize`).

`render(camera, scene, …)` mirrors the reference wrapper
(2d-gaussian-splatting/gaussian_renderer/__init__.py:19-170): one call returns
the RGB render plus every auxiliary map (alpha, world/camera normals,
expected/median/surface depth, distortion, normals from depth) and the
densification hooks (screen radii, visibility).

Backends:
- "dense": O(P·npix) oracle, autograd            rasterize_dense.py
- "tiled": tile-binned PyTorch, autograd         rasterize_tiled.py
- "cuda":  tile-binned hand-written CUDA kernels rasterize_cuda.py
           (their plain PyTorch versions on CPU tensors); differentiable
           through B1 forward / B2 backward, except with need_aux=False.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from g4splat_torch.core.cameras import Camera
from g4splat_torch.core.geometry import depth_to_normal
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.preprocess_cuda import camera_requires_grad, preprocess_splats
from g4splat_torch.ops.rasterize_common import Preprocessed, RenderConfig, preprocess
from g4splat_torch.utils.profiling import annotate, count


def render(
    camera: Camera,
    scene: GaussianScene,
    config: Optional[RenderConfig] = None,
    center_offset: Optional[torch.Tensor] = None,
    override_color: Optional[torch.Tensor] = None,
    backend: str = "tiled",
    need_aux: bool = True,
) -> Dict[str, torch.Tensor]:
    """Render `scene` from `camera` on the scene's device.

    need_aux=False selects the forward-only inference kernel on the cuda
    backend (no distortion / n_contrib / moments — those outputs are zeros;
    it refuses inputs that require grad); `config.compute_distortion=False`
    drops only the distortion channel there. The dense and tiled backends
    compute everything.
    """
    config = config or RenderConfig()
    H, W = camera.height, camera.width
    dev = scene.device

    with annotate("g4s:render.preprocess"):
        prep = _preprocess(camera, scene, config, center_offset, override_color)
    with annotate("g4s:sync.bg"):
        bg = torch.as_tensor(config.bg, dtype=torch.float32).to(dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)

    if backend == "dense":
        from g4splat_torch.ops.rasterize_dense import render_dense

        out = render_dense(camera, prep, bg, near=config.near, far=config.far)
        maps = {k: getattr(out, k).reshape((H, W) + getattr(out, k).shape[1:])
                for k in ("color", "normal", "depth_acc", "alpha", "median_depth",
                          "distortion", "final_T", "n_contrib", "m1_tot", "m2_tot")}
        n_dropped = n_overflow = zero_i     # the dense oracle composites every splat
    elif backend == "tiled":
        from g4splat_torch.ops.rasterize_tiled import render_tiled

        maps, binning = render_tiled(
            camera, prep, bg, near=config.near, far=config.far,
            tile_k=config.tile_k,
            max_tiles_per_splat=config.max_tiles_per_splat,
            ellipse_prune=config.tile_ellipse_prune)
        n_dropped, n_overflow = binning.n_dropped, binning.n_overflow
    elif backend == "cuda":
        from g4splat_torch.ops.rasterize_cuda import (
            rasterize_diff,
            rasterize_entries,
            splat_table,
        )
        from g4splat_torch.ops.rasterize_tiled import bin_splats

        binning = bin_splats(prep, W, H,
                             max_tiles_per_splat=config.max_tiles_per_splat,
                             ellipse_prune=config.tile_ellipse_prune)
        if need_aux:
            maps = rasterize_diff(prep, binning, bg, W, H, near=config.near,
                                  far=config.far, want_dist=config.compute_distortion)
        else:
            diff = (prep.T, prep.center, prep.opacity, prep.rgb, prep.normal)
            if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
                raise RuntimeError(
                    "render(backend='cuda', need_aux=False) is the forward-only "
                    "inference path; use need_aux=True for gradients, or run "
                    "under torch.no_grad()")
            maps = rasterize_entries(splat_table(prep), binning.gauss_id,
                                     binning.tile_start, binning.tile_count, bg, W, H,
                                     near=config.near, far=config.far, want_aux=False)
        n_dropped, n_overflow = binning.n_dropped, binning.n_overflow
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return postprocess(camera, config, prep, maps, n_dropped, n_overflow)


def _preprocess(camera: Camera, scene: GaussianScene, config: RenderConfig,
                center_offset: Optional[torch.Tensor],
                override_color: Optional[torch.Tensor]) -> Preprocessed:
    """The one choice of preprocess path, by what the inputs are: CUDA
    tensors run the kernels of `preprocess_cuda` (every backend), CPU tensors
    and a camera that requires grad (the kernels give it none) the torch
    chain of `rasterize_common.preprocess`."""
    count("render.preprocesses")
    kw = dict(xyz=scene.xyz, scaling=scene.scaling(), rotation_raw=scene.rotation_raw,
              opacity=scene.opacity(), sh_degree=scene.active_sh_degree,
              colors=override_color, config=config, center_offset=center_offset)
    if scene.xyz.is_cuda and not camera_requires_grad(camera):
        count("render.preprocesses_kernel")
        return preprocess_splats(camera, f_dc=scene.f_dc, f_rest=scene.f_rest, **kw)
    return preprocess(camera, features=scene.features(), **kw)


def postprocess(camera: Camera, config: RenderConfig, prep: Preprocessed,
                maps: Dict[str, torch.Tensor], n_dropped: torch.Tensor,
                n_overflow: torch.Tensor) -> Dict[str, torch.Tensor]:
    """render()'s last stage, identical to the reference wrapper (:117-164):
    the backend's (H, W) maps → the output dict (depths, world/camera
    normals, normals from depth, densification hooks)."""
    alpha = maps["alpha"]
    normal_cam = maps["normal"]
    R_c2w = camera.c2w[:3, :3]
    normal_world = normal_cam @ R_c2w.T

    depth_expected = torch.nan_to_num(maps["depth_acc"] / torch.clamp(alpha, min=1e-10))
    depth_median = torch.nan_to_num(maps["median_depth"])
    surf_depth = (depth_expected * (1.0 - config.depth_ratio)
                  + config.depth_ratio * depth_median)
    surf_normal_world = depth_to_normal(camera, surf_depth) * alpha.detach()[..., None]
    surf_normal_cam = surf_normal_world @ R_c2w          # world→cam rotation

    out = {
        "render": maps["color"],
        "radii": prep.radius,
        "visibility_filter": prep.radius > 0,
        "rend_alpha": alpha,
        "rend_normal": normal_world,
        "rend_normal_cam": normal_cam,
        "rend_dist": maps["distortion"],
        "rend_depth": depth_expected,
        "depth_median": depth_median,
        "surf_depth": surf_depth,
        "surf_normal": surf_normal_world,
        "surf_normal_cam": surf_normal_cam,
        "final_T": maps["final_T"],
        "n_contrib": maps["n_contrib"],
        # Distortion moment totals Σw·m / Σw·m² (for depth-slab composition).
        "dist_m1": maps["m1_tot"],
        "dist_m2": maps["m2_tot"],
        # Entries lost to the per-splat tile cap; n_overflow (entry-buffer
        # overflow) is always 0 here, the entry list being sized exactly.
        "n_dropped": n_dropped,
        "n_overflow": n_overflow,
    }
    return out


def mark_visible(camera: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """Frustum visibility of 3D points (rasterizer markVisible): view z ≥ 0.2."""
    p_view = xyz @ camera.w2c[:3, :3].T + camera.w2c[:3, 3]
    return p_view[:, 2] >= 0.2
