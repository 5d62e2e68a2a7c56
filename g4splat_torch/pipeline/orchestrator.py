"""The end-to-end pipeline: its state, artifact store and stages
(counterpart of `g4splat_tpu.pipeline.orchestrator`).

`G4SplatPipeline` holds a `PipelineState` on one device (the card unless the
caller passes ``device="cpu"``) and runs, as methods over it, the JAX
package's `run()` in its order:

    load_inputs → run_sfm → align_charts → render_chart_views →
    excavate_planes → refine_plane_depths → train_gaussians →
    for k in 1..n_see3d_stages: see3d_stage(k) →
    refine_plane_depths(use_anchor_colors=k == 3) → train_gaussians →
    extract_mesh → evaluate

(dense-view mode: dense_view_stage, refine_plane_depths, train_gaussians in
place of the See3D rounds). Prior networks are injected (`Priors`). The
on-disk artifacts keep the reference's layout (sfm/sparse/0 COLMAP model,
points.ply, cameras.json, pointmaps/, charts_data.npz,
plane-refine-depths/ file zoo, see3d_render/stage{k}, see3d_cameras.npz,
point_cloud/iteration_N/point_cloud.ply, renders, the mesh, result_iter_N).
Maps stay on the device until they are written; PNG, TIFF and NPY writes
are encoded on the I/O thread pool. `stage_done` reads which stages an
earlier run finished from those files, and `resume_from_artifacts` rebuilds
the state from them, so that a stage can run again on a fresh pipeline.

On several devices (`parallel.mesh.available_devices`: the visible cards,
or the CPU alone) the view sweeps fan out over them, the DA2 and SAM view
batches and the MASt3R pair batch split over them, and `train_gaussians`
trains data-parallel when `data_parallel_training` asks for it; on one
device every branch is the single-device one. The CLI is not part of this
module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from g4splat_torch.core.cameras import Camera, camera_at, make_camera, stack_cameras
from g4splat_torch.core.geometry import depth_to_normal
from g4splat_torch.device import DeviceLike, resolve_device
from g4splat_torch.eval.image_metrics import LPIPS, evaluate_images
from g4splat_torch.eval.mesh_metrics import evaluate_mesh
from g4splat_torch.io import colmap as colmap_io
from g4splat_torch.io.images import (
    flush_io,
    save_depth_tiff_async,
    save_image_async,
    save_mask_png_async,
    save_npy_async,
)
from g4splat_torch.io.ply import save_gaussian_ply, save_mesh_ply, save_point_cloud_ply
from g4splat_torch.ops.depth_align import depth_linear_align
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.parallel import mesh as pmesh
from g4splat_torch.pipeline import sfm as S
from g4splat_torch.pipeline.chart_alignment import (
    ChartAlignConfig,
    align_charts,
    save_charts_data,
)
from g4splat_torch.pipeline.confidence import (
    anchor_plane_color_harmonize,
    build_visibility_masks,
    compute_confidence_maps,
)
from g4splat_torch.pipeline.evaluate import write_results
from g4splat_torch.pipeline.gaussian_init import (
    init_by_warp_from_depths,
    init_from_manifold_meshes,
    scene_from_init,
)
from g4splat_torch.pipeline.mesh_extraction import (
    MeshExtractionConfig,
    cameras_spatial_extent,
    extract_mesh_adaptive_tsdf,
    extract_mesh_multires_tsdf,
    filter_mesh_by_edge_length,
    keep_largest_clusters,
    mesh_config_from,
)
from g4splat_torch.pipeline.novel_views import (
    ProposalConfig,
    VisibilityGrid,
    none_visible_rate_from_alpha,
    propose_look_around,
    propose_object_centric,
    propose_plane_targeted,
    select_need_inpaint_views,
)
from g4splat_torch.pipeline.planes import (
    PlaneExcavator,
    PlaneExcavatorConfig,
    merge_global_planes,
    refine_depths_with_planes,
)
from g4splat_torch.pipeline.render_all import render_camera_batch
from g4splat_torch.pipeline.retrieval import retrieval_pairs
from g4splat_torch.pipeline.see3d_stage import run_see3d_inpaint
from g4splat_torch.priors.mast3r import extract_correspondences
from g4splat_torch.train.losses import normal_to_curvature
from g4splat_torch.train.trainer import Trainer, TrainConfig, ViewData
from g4splat_torch.utils.config import apply_overrides, load_config


@dataclass
class PipelineConfig:
    # The reference's train.py flag surface (train.py:22-78).
    source_path: str = ""
    output_path: str = ""
    n_images: Optional[int] = None
    sfm_config: str = "unposed"
    alignment_config: str = "default"
    free_gaussians_config: str = "default"
    tetra_config: str = "default"
    tsdf_config: str = "default"
    tetra_downsample_ratio: float = 0.5
    select_inpaint_num: int = 20
    n_see3d_stages: int = 3
    none_visible_low: float = 0.05
    none_visible_high: float = 0.5
    use_dense_view: bool = False
    use_mesh_filter: bool = False
    use_multires_tsdf: bool = False
    tsdf_resolution: int = 128
    multires_factors: Tuple[float, ...] = (2.0, 8.0, 16.0)
    use_downsample_gaussians: bool = False
    downsample_gaussians_type: str = "warp"
    warp_depth_error_thresh: float = 0.01
    warp_downsample_pixel_grid_size: int = -1
    depthanything_encoder: str = "vitl"
    downweight_input_view_color_loss: bool = False
    use_interpolated_views: bool = True
    dense_regul: str = "default"
    work_size: int = 512
    # See3D runs at a fixed square resolution; None keeps the warps' size.
    mvd_resolution: Optional[int] = 512
    # Frames per MVD batch beyond the pinned references (None: all at once).
    see3d_group_size: Optional[int] = None
    see3d_super_resolution: bool = False
    # Voxel visibility grid over input-observed space; <= 0 disables it.
    vis_grid_resolution: int = 256
    train_iterations: int = 7000
    gaussian_capacity: int = 2_000_000
    render_backend: str = "cuda"
    eval_split: Optional[List[int]] = None
    data_parallel_training: Optional[bool] = None


@dataclass
class Priors:
    """Injected prior networks (None → the stage degrades gracefully)."""
    depth_model: Optional[object] = None       # DepthAnything
    mast3r: Optional[object] = None            # MASt3RModel
    sam_generator: Optional[object] = None     # callable image → masks
    see3d: Optional[object] = None             # See3DPipeline
    see3d_sr: Optional[object] = None          # SR checkpoint, else see3d
    vae: Optional[object] = None               # AutoencoderKL
    image_embedder: Optional[object] = None    # (H, W, 3) image → (1, 77, C)
    text_embedder: Optional[object] = None     # () → (1, 77, C)
    lpips: Optional[object] = None


@dataclass
class PipelineState:
    """Maps and cameras are tensors on the pipeline's device; plane masks and
    pixel → point ids are host numpy, as the plane stages read them."""
    images: torch.Tensor = None            # (V, H, W, 3)
    cameras: Camera = None                 # batched (V,)
    input_view_num: int = 0
    sfm_points: torch.Tensor = None
    sfm_point_colors: torch.Tensor = None
    depths: torch.Tensor = None            # (V, H, W) current refined depths
    prior_depths: torch.Tensor = None
    normals: torch.Tensor = None           # (V, H, W, 3) world
    curvs: torch.Tensor = None
    confidences: torch.Tensor = None       # (V, H, W)
    scale_factor: float = 1.0
    plane_masks: List[np.ndarray] = field(default_factory=list)
    pixel_point_ids: List[np.ndarray] = field(default_factory=list)
    global_plane_points: List[np.ndarray] = field(default_factory=list)
    global_plane_dict: Dict = field(default_factory=dict)
    fitted_planes: List[Dict] = field(default_factory=list)
    scene: object = None                   # GaussianScene
    color_weights: torch.Tensor = None     # (V,)
    test_images: torch.Tensor = None
    test_cameras: Camera = None
    anchor_view_ids: List[int] = field(default_factory=list)


class ArtifactStore:
    """Reference-compatible output layout."""

    def __init__(self, root: str):
        self.root = root
        self.sparse = os.path.join(root, "sfm", "sparse", "0")
        self.charts = os.path.join(root, "sfm", "charts_data.npz")
        self.plane_root = os.path.join(root, "sfm", "plane-refine-depths")
        self.see3d_root = os.path.join(root, "sfm", "see3d_render")
        self.gaussians = os.path.join(root, "free_gaussians")
        self.meshes = os.path.join(root, "tetra_meshes")
        for d in (self.sparse, self.plane_root, self.see3d_root, self.gaussians, self.meshes):
            os.makedirs(d, exist_ok=True)

    def point_cloud_dir(self, iteration: int) -> str:
        d = os.path.join(self.gaussians, "point_cloud", f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        return d

    def renders_dir(self, split: str, iteration: int) -> str:
        d = os.path.join(self.gaussians, split, f"ours_{iteration}", "renders")
        os.makedirs(d, exist_ok=True)
        return d


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _point_ids(depth: torch.Tensor, first: int) -> np.ndarray:
    """(H, W) ids first, first + 1, … of a view's chart points, row-major,
    and 0 (no point) where the depth is ≤ 0: there the view sees nothing,
    and its backprojected point would be the camera centre, which a plane
    fit would take as a surface (ROADMAP C12)."""
    H, W = depth.shape
    ids = np.arange(first, first + H * W).reshape(H, W)
    ids[(depth <= 0).cpu().numpy()] = 0
    return ids


class G4SplatPipeline:
    def __init__(self, config: PipelineConfig, priors: Optional[Priors] = None,
                 device: DeviceLike = None):
        self.cfg = config
        self.priors = priors if priors is not None else Priors()
        self.device = resolve_device(device)
        self.store = ArtifactStore(config.output_path)
        self.state = PipelineState()
        self.timings: Dict[str, float] = {}
        # Every timed call in order, (name, seconds): a name repeats per round.
        self.timing_log: List[Tuple[str, float]] = []
        self._last_sr_preds = None
        # Per See3D stage: candidates, their none-visible rates, the selected
        # ids and the view count after the merge.
        self.stage_reports: Dict[int, Dict] = {}

    # ------------------------------------------------------------- utilities
    @contextlib.contextmanager
    def _timed(self, name: str):
        """Host-clock seconds of the block (the card synchronized at both ends)."""
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.time()
        yield
        sync()
        self.timings[name] = time.time() - t0
        self.timing_log.append((name, self.timings[name]))
        print(f"[pipeline] {name}: {self.timings[name]:.1f}s", flush=True)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    def _prior_mesh(self, n_items: int) -> Optional[pmesh.DeviceMesh]:
        """The data mesh the per-view prior batches (DA2, SAM) shard their
        view axis over; None on one device."""
        return pmesh.fan_mesh(self.device, n_items)

    def _mono_disparity(self, images: torch.Tensor) -> torch.Tensor:
        """DA2 disparity for a same-size view stack, in slabs, the view axis
        split over the device mesh when there is one."""
        return self.priors.depth_model.infer_images(
            images, mesh=self._prior_mesh(len(images)))

    def _normals_curvs(self, cameras: Camera, depths: torch.Tensor):
        normals = torch.stack([depth_to_normal(camera_at(cameras, v), depths[v])
                               for v in range(depths.shape[0])])
        return normals, torch.stack([normal_to_curvature(n) for n in normals])

    # ---------------------------------------------------------------- stages
    def load_inputs(self, images, cameras: Optional[Camera] = None, test_images=None,
                    test_cameras: Optional[Camera] = None):
        """Load the views (and calibrated cameras) onto the pipeline's device;
        `cfg.eval_split` holds the listed views out as the test split."""
        images = self._tensor(images)
        if self.cfg.eval_split:
            test_ids = sorted(set(int(i) for i in self.cfg.eval_split))
            train_ids = [i for i in range(len(images)) if i not in test_ids]
            assert train_ids, "eval_split holds out every view"
            test_images = images[test_ids]
            if cameras is not None:
                test_cameras = stack_cameras([camera_at(cameras, i) for i in test_ids])
                cameras = stack_cameras([camera_at(cameras, i) for i in train_ids])
            images = images[train_ids]
        st = self.state
        st.images = images
        st.cameras = cameras.to(self.device) if cameras is not None else None
        st.input_view_num = len(images)
        st.test_images = self._tensor(test_images) if test_images is not None else None
        st.test_cameras = test_cameras.to(self.device) if test_cameras is not None else None
        w0 = 0.01 if self.cfg.downweight_input_view_color_loss else 1.0
        st.color_weights = torch.full((len(images),), w0, device=self.device)

    def run_sfm(self):
        """MASt3R-SfM: pairs → pointmaps → correspondences → sparse global
        alignment → COLMAP writeout."""
        st = self.state
        V, H, W = st.images.shape[:3]
        posed = st.cameras is not None and self.cfg.sfm_config == "posed"
        with self._timed("sfm"):
            if posed:
                # pp → centre, fx == fy.
                st.images, st.cameras = S.rectify_to_center_pp(st.images, st.cameras)
            if self.priors.mast3r is None:
                # Posed mode can bootstrap depths from the mono prior (or a
                # flat far plane); unposed cannot.
                assert posed, "unposed SfM requires the MASt3R prior"
                self._posed_depth_bootstrap()
                return
            model = self.priors.mast3r
            # Exhaustive pairs for sparse view sets, a retrieval shortlist
            # above 20 views.
            if V > 20:
                feats = [_host(model.encode_image(st.images[v:v + 1])[0]) for v in range(V)]
                pair_ids = retrieval_pairs(feats, exhaustive_threshold=20)
            else:
                pair_ids = S.build_pairs_exhaustive(V)
            if hasattr(model, "symmetric_inference_batch"):
                # The pair axis splits over the cards when there are several;
                # the CPU keeps one batch, as the JAX package does.
                mesh = (pmesh.fan_mesh(self.device, 2 * len(pair_ids))
                        if self.device.type != "cpu" and len(pair_ids) > 1 else None)
                outs = model.symmetric_inference_batch(st.images[[i for i, _ in pair_ids]],
                                                       st.images[[j for _, j in pair_ids]],
                                                       mesh=mesh)
            else:
                outs = [model.symmetric_inference(st.images[i:i + 1], st.images[j:j + 1])
                        for i, j in pair_ids]
            pair_outputs, pairs = {}, []
            for (i, j), o in zip(pair_ids, outs):
                pair_outputs[(i, j)] = o
                xy1, xy2, conf = extract_correspondences(
                    o[0]["desc"][0], o[2]["desc"][0], o[0]["desc_conf"][0], o[2]["desc_conf"][0])
                # DUSt3R regression targets (X12: image-i pixels in frame j)
                # for correspondence-starved pairs.
                p12 = _host(o[3]["pts3d"][0])
                c12 = _host(o[3]["conf"][0])
                hh, ww = c12.shape
                ys, xs = np.mgrid[:hh, :ww]
                stride = max(1, int(np.sqrt(hh * ww / 1024)))
                sl = (slice(None, None, stride), slice(None, None, stride))
                pairs.append(S.PairData(
                    i=i, j=j, xy_i=xy1, xy_j=xy2, conf=conf, score=float(conf.sum()),
                    T_ji=S.relative_pose_from_pair(o[0], o[2], o[3]),
                    xy_reg=np.stack([xs[sl], ys[sl]], -1).reshape(-1, 2).astype(np.float32),
                    pts_reg=p12[sl].reshape(-1, 3), conf_reg=c12[sl].reshape(-1)))
            depths, focals, canon_confs = S.canonical_views_from_pairs(V, pair_outputs,
                                                                       return_confs=True)
            del outs, pair_outputs
            init_w2c = None
            if posed:
                init_w2c = _host(st.cameras.w2c)
                focals = _host(st.cameras.fx)
            # The schedule from configs/mast3r/{posed,unposed}.yaml.
            sfm_cfg = apply_overrides(S.SfMConfig(), load_config("mast3r", self.cfg.sfm_config))
            if not posed:
                # Without provided cameras poses and intrinsics are optimised
                # whatever the YAML says.
                sfm_cfg = dataclasses.replace(sfm_cfg, fix_poses=False,
                                              optimize_intrinsics=True)
            res = S.sparse_global_alignment(depths, focals, pairs, sfm_cfg, init_w2c=init_w2c,
                                            device=self.device)
            st.cameras = stack_cameras([
                make_camera(res.w2c[v], res.focals[v], res.focals[v], (W - 1) / 2, (H - 1) / 2,
                            W, H, device=self.device) for v in range(V)])
            st.prior_depths = self._tensor(res.depthmaps)
            st.depths = st.prior_depths.clone()
            # clean_depth: zero the confidence of cross-view floaters so the
            # COLMAP writeout drops them.
            confs = S.clean_depth_confidences(res.w2c, res.focals, res.depthmaps, canon_confs)
            self._write_colmap(res, confs=confs)

    def _posed_depth_bootstrap(self):
        """Posed mode without MASt3R: depths from the DA2 mono prior scaled
        to the camera extent (or a flat plane at the extent), then the SfM
        writeout."""
        st = self.state
        V, H, W = st.images.shape[:3]
        extent = max(cameras_spatial_extent(st.cameras), 1e-3)
        if self.priors.depth_model is not None:
            d = 1.0 / torch.clamp(self._mono_disparity(st.images), min=1e-6)
            med = torch.clamp(torch.median(d.reshape(V, -1), dim=1).values, min=1e-9)
            depths = d * (extent / med)[:, None, None]
        else:
            depths = torch.full((V, H, W), extent, device=self.device)
        st.prior_depths = depths.to(torch.float32)
        st.depths = st.prior_depths.clone()
        self._write_colmap(S.SfMResult(w2c=_host(st.cameras.w2c), focals=_host(st.cameras.fx),
                                       depthmaps=_host(st.depths), losses=[]))

    def _write_colmap(self, res, confs: Optional[np.ndarray] = None):
        """The COLMAP writeout, points.ply, cameras.json and the per-view
        JSON pointmaps. ``confs`` (V, H, W), when given, gates which
        backprojected points are written (the reference's output_conf_thr
        0.1 over the cleaned confidences)."""
        st = self.state
        V, H, W = st.images.shape[:3]
        conf_thr = 0.1
        cams = {v + 1: colmap_io.ColmapCamera(
            v + 1, "PINHOLE", W, H,
            np.array([res.focals[v], res.focals[v], (W - 1) / 2, (H - 1) / 2]))
            for v in range(V)}
        images = {}
        for v in range(V):
            q = colmap_io.rotmat2qvec(res.w2c[v][:3, :3])
            images[v + 1] = colmap_io.ColmapImage(v + 1, q, res.w2c[v][:3, 3], v + 1,
                                                  f"frame_{v:06d}.png")
        host_images = _host(st.images)
        world = [_host(camera_at(st.cameras, v).backproject(self._tensor(res.depthmaps[v])))
                 for v in range(V)]
        # Sparse cloud: subsampled backprojected canonical points.
        pts = {}
        pid = 1
        all_pts, all_cols = [], []
        for v in range(V):
            step = 8
            sel = world[v][::step, ::step].reshape(-1, 3)
            col = host_images[v][::step, ::step].reshape(-1, 3)
            if confs is not None:
                keep = confs[v][::step, ::step].reshape(-1) >= conf_thr
                sel, col = sel[keep], col[keep]
            all_pts.append(sel)
            all_cols.append(col)
            for p, c in zip(sel[::4], col[::4]):
                pts[pid] = colmap_io.ColmapPoint3D(
                    pid, p, (c * 255).astype(np.uint8), 0.5,
                    np.array([v + 1], np.int32), np.array([0], np.int32))
                pid += 1
        st.sfm_points = np.concatenate(all_pts)
        st.sfm_point_colors = np.concatenate(all_cols)
        colmap_io.write_model(cams, images, pts, self.store.sparse)
        sfm_root = os.path.dirname(os.path.dirname(self.store.sparse))
        save_point_cloud_ply(os.path.join(sfm_root, "points.ply"), st.sfm_points,
                             st.sfm_point_colors)
        c2w = [np.linalg.inv(res.w2c[v]).tolist() for v in range(V)]
        with open(os.path.join(sfm_root, "cameras.json"), "w") as f:
            json.dump({"filepaths": [f"frame_{v:06d}.png" for v in range(V)],
                       "focals": [float(res.focals[v]) for v in range(V)],
                       "cams2world": c2w}, f)
        # pointmaps/<name>.json: per-view canonical points and confidences
        # (rgb omitted, as the reference's use_all_images branch does).
        pm_dir = os.path.join(sfm_root, "pointmaps")
        os.makedirs(pm_dir, exist_ok=True)
        for v in range(V):
            with open(os.path.join(pm_dir, f"frame_{v:06d}.json"), "w") as f:
                json.dump({
                    "rgb": None,
                    "points": world[v].reshape(-1, 3).tolist(),
                    "confs": (confs[v].reshape(-1) if confs is not None
                              else np.ones(H * W, np.float32)).tolist(),
                }, f)
        # Posed mode: all-sparse/0 (every calibrated view, original
        # intrinsics) and dense-view-sparse/0 (the dense_view.json subset).
        if self.cfg.sfm_config == "posed" and self.cfg.source_path:
            src_sparse = os.path.join(self.cfg.source_path, "sparse", "0")
            if os.path.isdir(src_sparse):
                try:
                    acams, aimgs, _ = colmap_io.read_model(src_sparse)
                except Exception:
                    acams = aimgs = None
                if acams:
                    all_dir = os.path.join(sfm_root, "all-sparse", "0")
                    os.makedirs(all_dir, exist_ok=True)
                    colmap_io.write_model(acams, aimgs, {}, all_dir)
                    dv_json = os.path.join(self.cfg.source_path, "dense_view.json")
                    if os.path.exists(dv_json):
                        with open(dv_json) as f:
                            dense_ids = json.load(f)["train"]
                        img_items = sorted(aimgs.items())
                        d_cams, d_imgs = {}, {}
                        for k, idx in enumerate(dense_ids):
                            _, im = img_items[idx]
                            cam_src = acams[im.camera_id]
                            d_cams[k + 1] = colmap_io.ColmapCamera(
                                k + 1, cam_src.model, cam_src.width, cam_src.height,
                                cam_src.params)
                            d_imgs[k + 1] = colmap_io.ColmapImage(k + 1, im.qvec, im.tvec, k + 1,
                                                                  im.name)
                        dv_dir = os.path.join(sfm_root, "dense-view-sparse", "0")
                        os.makedirs(dv_dir, exist_ok=True)
                        colmap_io.write_model(d_cams, d_imgs, {}, dv_dir)

    def align_charts(self):
        """Chart alignment: DA2 mono depth affine-aligned to the SfM depths,
        then the deformation-field refinement; writes charts_data.npz."""
        st = self.state
        with self._timed("align_charts"):
            V = st.images.shape[0]
            disps = (self._mono_disparity(st.images)
                     if self.priors.depth_model is not None else None)
            init_depths = []
            for v in range(V):
                ref = st.prior_depths[v]
                if disps is not None:
                    aligned, _, _ = depth_linear_align(disps[v], ref, ref > 0)
                    init_depths.append(aligned)
                else:
                    init_depths.append(ref)
            extent = max(cameras_spatial_extent(st.cameras), 1e-3)
            # The schedule from configs/charts_alignment/; an unknown name
            # falls back to default.
            try:
                ycfg = load_config("charts_alignment", self.cfg.alignment_config)
            except FileNotFoundError:
                ycfg = load_config("charts_alignment", "default")
            res = align_charts(st.cameras, torch.stack(init_depths), st.prior_depths,
                               extent=extent, cfg=apply_overrides(ChartAlignConfig(), ycfg))
            st.depths = res.depths
            st.prior_depths = res.prior_depths
            st.confidences = res.confs
            save_charts_data(self.store.charts, res, st.scale_factor)

    def render_chart_views(self):
        """Chart-view file zoo: depths, normals, curvatures, covisibility
        counts, the chart point cloud, and the pixel → point ids."""
        st = self.state
        root = self.store.plane_root
        with self._timed("render_chart_views"):
            V, H, W = st.depths.shape
            prior_depths = st.prior_depths if st.prior_depths is not None else st.depths
            normals, curvs, pid_maps, all_pts = [], [], [], []
            next_id = 1
            for v in range(V):
                cam = camera_at(st.cameras, v)
                n = depth_to_normal(cam, st.depths[v])
                mono_n = depth_to_normal(cam, prior_depths[v])
                normals.append(mono_n)
                curvs.append(normal_to_curvature(mono_n))
                all_pts.append(cam.backproject(st.depths[v]).reshape(-1, 3))
                pid_maps.append(_point_ids(st.depths[v], next_id))
                next_id += H * W
                save_image_async(os.path.join(root, f"rgb_frame{v:06d}.png"), st.images[v])
                save_depth_tiff_async(os.path.join(root, f"depth_frame{v:06d}.tiff"),
                                      st.depths[v])
                save_depth_tiff_async(os.path.join(root, f"mono_depth_frame{v:06d}.tiff"),
                                      prior_depths[v])
                save_npy_async(os.path.join(root, f"depth_normal_world_frame{v:06d}.npy"), n)
                save_npy_async(os.path.join(root, f"mono_normal_world_frame{v:06d}.npy"),
                               mono_n)
            vis_counts, _ = build_visibility_masks(st.cameras, st.depths)
            for v in range(V):
                save_npy_async(os.path.join(root, f"visibility_frame{v:06d}.npy"), vis_counts[v])
            flush_io()
            st.normals = torch.stack(normals)
            st.curvs = torch.stack(curvs)
            st.pixel_point_ids = pid_maps
            chart_pts = torch.cat(all_pts)
            save_point_cloud_ply(os.path.join(root, "chart_pcd.ply"), chart_pts)
            self._chart_points = torch.cat([chart_pts.new_zeros((1, 3)), chart_pts])

    def excavate_planes(self):
        """Per-view plane masks and their global merge."""
        st = self.state
        with self._timed("excavate_planes"):
            exc = PlaneExcavator(PlaneExcavatorConfig(),
                                 mask_generator=self.priors.sam_generator)
            gen = self.priors.sam_generator
            # One encoder pass over the view stack (split over the device
            # mesh when there is one); prompting and NMS per view.
            pre = (gen.batch(st.images, mesh=self._prior_mesh(len(st.images)))
                   if gen is not None and hasattr(gen, "batch") else None)
            st.plane_masks = []
            for v in range(len(st.images)):
                out = exc(st.images[v], st.normals[v],
                          seg_masks=None if pre is None else pre[v])
                st.plane_masks.append(out["seg_mask"])
                np.save(os.path.join(self.store.plane_root, f"plane_mask_frame{v:06d}.npy"),
                        out["seg_mask"])
            st.global_plane_points, st.global_plane_dict = merge_global_planes(
                st.pixel_point_ids, st.plane_masks)
            with open(os.path.join(self.store.plane_root, "global_3Dplane_ID_dict.json"),
                      "w") as f:
                json.dump({str(k): v for k, v in st.global_plane_dict.items()}, f)

    def refine_plane_depths(self, use_anchor_colors: bool = False):
        """Plane-refined depths and confidence maps. `use_anchor_colors` is
        the stage-3 variant: plane colours from the stage's anchor views, and
        all-ones confident maps."""
        st = self.state
        root = self.store.plane_root
        with self._timed("refine_plane_depths"):
            refined, planes = refine_depths_with_planes(
                st.cameras, st.depths, st.plane_masks, st.global_plane_dict,
                self._chart_points, st.global_plane_points, rend_normals=st.normals)
            st.depths = refined
            st.fitted_planes = planes
            for v in range(len(st.images)):
                save_depth_tiff_async(os.path.join(root, f"refine_depth_frame{v:06d}.tiff"),
                                      refined[v])
            flush_io()
            if use_anchor_colors and st.anchor_view_ids:
                st.images = anchor_plane_color_harmonize(
                    st.cameras, st.depths, st.images, st.plane_masks, st.global_plane_dict,
                    st.anchor_view_ids)
                st.confidences = torch.ones_like(st.depths)
            elif len(st.images) == st.input_view_num:
                st.confidences = torch.ones_like(st.depths)
            else:
                pts = torch.cat([camera_at(st.cameras, v).backproject(refined[v])
                                 .reshape(-1, 3)[::4] for v in range(len(st.images))])
                out = compute_confidence_maps(st.cameras, pts, refined, st.images,
                                              st.input_view_num)
                st.confidences = out.confident_maps.to(torch.float32)
                st.images = out.harmonized_images
            for v in range(len(st.images)):
                save_mask_png_async(os.path.join(root, f"confident_map_frame{v:06d}.png"),
                                    st.confidences[v] > 0.5)
            flush_io()

    def train_gaussians(self, iterations: Optional[int] = None):
        """2DGS training restarted from an init on the current view set."""
        st = self.state
        cfg = self.cfg
        with self._timed("train_gaussians"):
            if cfg.use_downsample_gaussians and cfg.downsample_gaussians_type == "warp":
                parts = init_by_warp_from_depths(
                    st.cameras, st.depths, st.images,
                    depth_error_thresh=cfg.warp_depth_error_thresh,
                    downsample_pixel_grid_size=cfg.warp_downsample_pixel_grid_size)
            else:
                voxel = 0.0
                if cfg.use_downsample_gaussians:
                    voxel = 0.01 * max(cameras_spatial_extent(st.cameras), 1e-3)
                parts = init_from_manifold_meshes(st.cameras, st.depths, st.images,
                                                  voxel_downsample=voxel)
            n = len(parts["means"])
            if n > cfg.gaussian_capacity:
                # Hard cap: an evenly strided subset (the points arrive in view
                # order) at ~77 % of the capacity, so densification has room.
                target = max(1, cfg.gaussian_capacity * 10 // 13)
                keep = torch.as_tensor(np.linspace(0, n - 1, target, dtype=np.int64),
                                       device=self.device)
                parts = {k: (v[keep] if getattr(v, "ndim", 0) >= 1 and len(v) == n else v)
                         for k, v in parts.items()}
                print(f"[pipeline] init points {n} exceed gaussian_capacity "
                      f"{cfg.gaussian_capacity}: strided subset kept", flush=True)
                n = target
            scene = scene_from_init(parts, capacity=min(cfg.gaussian_capacity,
                                                        max(2 * n, n + 1024)))

            extent = max(cameras_spatial_extent(st.cameras), 1e-3)
            iters = iterations or cfg.train_iterations
            try:
                sched = load_config("free_gaussians_refinement", cfg.free_gaussians_config)
            except FileNotFoundError:
                sched = {}
            ratio = iters / max(sched.get("iterations", iters), 1)
            tcfg = TrainConfig(
                iterations=iters,
                densify_until_iter=max(1, int(sched.get("densify_until_iter", iters // 2)
                                              * ratio)),
                # Unscaled: the reset interval is an absolute cadence.
                opacity_reset_interval=int(sched.get("opacity_reset_interval", 1000)),
                normal_consistency_from=int(sched.get("normal_consistency_from", iters // 2)
                                            * ratio),
                distortion_from=int(sched.get("distortion_from", iters // 5) * ratio),
                use_mip_filter=bool(sched.get("use_mip_filter", True)),
                depth_ratio=float(sched.get("depth_ratio", 0.5)),
                spatial_lr_scale=extent,
                backend=cfg.render_backend,
                raster_compact_width=int(sched.get("raster_compact_width", 4)),
            )
            views = ViewData(image=st.images, prior_depth=st.depths, prior_normal=st.normals,
                             prior_curv=st.curvs, confidence=st.confidences,
                             color_weight=st.color_weights,
                             scale_factor=torch.tensor(10.0, device=self.device))
            # Data-parallel training only on request: the JAX package's A/B
            # (equal view visits, same schedule) put 8-way DP 11 dB below
            # single-device training. It takes the largest divisor of V no
            # larger than the device count.
            mesh = None
            devs = pmesh.available_devices(self.device)
            V = len(st.images)
            if cfg.data_parallel_training and len(devs) > 1:
                n_data = max((d for d in range(2, min(len(devs), V) + 1) if V % d == 0),
                             default=0)
                if n_data >= 2:
                    mesh = pmesh.make_mesh(n_data=n_data, devices=devs[:n_data])
            trainer = Trainer(scene, st.cameras, views, tcfg, mesh=mesh)
            trainer.train(iters)
            st.scene = trainer.scene
            save_gaussian_ply(os.path.join(self.store.point_cloud_dir(iters),
                                           "point_cloud.ply"), st.scene)

    def see3d_stage(self, stage: int):
        """Novel-view proposal, candidate sweep, selection, inpainting, depth
        lift and merge into the training set."""
        st = self.state
        cfg = self.cfg
        with self._timed(f"see3d_stage{stage}"):
            H, W = st.images.shape[1:3]
            pcfg = ProposalConfig(n_frames=4 * cfg.select_inpaint_num, width=W, height=H)
            input_cams = stack_cameras([camera_at(st.cameras, i)
                                        for i in range(st.input_view_num)])
            stage_dir = os.path.join(self.store.see3d_root, f"stage{stage}")
            os.makedirs(stage_dir, exist_ok=True)

            # The current model on the train views; its depths also feed the
            # visibility grid.
            rt_dir = os.path.join(stage_dir, "render-train-views")
            os.makedirs(rt_dir, exist_ok=True)
            maps_t = self._render_maps_batch(st.cameras, len(st.images),
                                             keys=("render", "surf_depth"), depth_ratio=0.5)
            for idx in range(len(st.images)):
                save_image_async(os.path.join(rt_dir, f"{idx:05d}.png"), maps_t["render"][idx])
                save_depth_tiff_async(os.path.join(rt_dir, f"depth_{idx:05d}.tiff"),
                                      maps_t["surf_depth"][idx])

            grid = None
            if cfg.vis_grid_resolution > 0:
                alive_xyz = st.scene.xyz.detach()[st.scene.alive]
                grid = VisibilityGrid(alive_xyz.min(0).values, alive_xyz.max(0).values,
                                      cfg.vis_grid_resolution, st.cameras,
                                      maps_t["surf_depth"])
                inv = np.stack(np.nonzero(~grid.grid), -1)
                if len(inv):
                    inv_pts = (grid.bbox_min + (inv[:: max(1, len(inv) // 100_000)] + 0.5)
                               * grid.grid_size)
                    save_point_cloud_ply(os.path.join(stage_dir, "invisible_points.ply"),
                                         inv_pts.astype(np.float32))
            del maps_t
            if stage == 1:
                cand = propose_object_centric(input_cams, grid=grid, cfg=pcfg)
            elif stage == 2:
                cand = propose_look_around(
                    input_cams, pcfg,
                    n_per_view=max(2, 4 * cfg.select_inpaint_num // max(st.input_view_num, 1)))
            elif st.fitted_planes:
                cand = propose_plane_targeted(
                    input_cams, np.stack([p["center"] for p in st.fitted_planes]),
                    np.stack([p["normal"] for p in st.fitted_planes]), grid=grid, cfg=pcfg)
            else:
                cand = propose_object_centric(input_cams, grid=grid, cfg=pcfg)
            if cand is None:
                print(f"[pipeline] see3d stage {stage}: no candidates")
                flush_io()
                return
            n_cand = cand.w2c.shape[0]
            report = self.stage_reports[stage] = {"candidates": n_cand, "selected": [],
                                                  "views": len(st.images)}

            raw_dir = os.path.join(stage_dir, "raw-gs")
            os.makedirs(raw_dir, exist_ok=True)
            maps_c = self._render_maps_batch(cand, n_cand,
                                             keys=("render", "rend_alpha", "surf_depth"),
                                             depth_ratio=0.5)
            renders, alphas, depths_r = (maps_c[k] for k in ("render", "rend_alpha",
                                                             "surf_depth"))
            for i in range(n_cand):
                am = alphas[i] > 0.5
                save_image_async(os.path.join(raw_dir, f"ori_warp_frame{i:06d}.png"), renders[i])
                save_depth_tiff_async(os.path.join(raw_dir, f"depth_frame{i:06d}.tiff"),
                                      depths_r[i])
                save_npy_async(os.path.join(raw_dir, f"alpha_{i:06d}.npy"), alphas[i])
                save_mask_png_async(os.path.join(raw_dir, f"alpha_mask_frame{i:06d}.png"), am)
                save_mask_png_async(os.path.join(raw_dir, f"mask_frame{i:06d}.png"), am)
                save_image_async(os.path.join(raw_dir, f"warp_frame{i:06d}.png"),
                                 renders[i] * am[..., None])
            rates = [none_visible_rate_from_alpha(a) for a in alphas]
            xyz = st.scene.xyz.detach()[st.scene.alive]
            sel = select_need_inpaint_views(cand, rates, xyz, select_num=cfg.select_inpaint_num,
                                            low_bound=cfg.none_visible_low,
                                            high_bound=cfg.none_visible_high)
            report.update(rates=rates, selected=list(sel))
            if not sel:
                print(f"[pipeline] see3d stage {stage}: no views selected "
                      f"(rates {min(rates):.2f}..{max(rates):.2f})")
                flush_io()
                return
            sel_dir = os.path.join(stage_dir, "select-gs")
            os.makedirs(sel_dir, exist_ok=True)
            sel_warps = [renders[vid] for vid in sel]
            sel_masks = [alphas[vid] > 0.5 for vid in sel]
            sel_pts = []
            for k, vid in enumerate(sel):
                save_image_async(os.path.join(sel_dir, f"warp_frame{k:06d}.png"), sel_warps[k])
                save_mask_png_async(os.path.join(sel_dir, f"mask_frame{k:06d}.png"),
                                    sel_masks[k])
                save_depth_tiff_async(os.path.join(sel_dir, f"depth_frame{k:06d}.tiff"),
                                      depths_r[vid])
                d = depths_r[vid]
                p = camera_at(cand, vid).backproject(torch.clamp(d, min=1e-3)).reshape(-1, 3)
                sel_pts.append(p[(d > 1e-6).reshape(-1)])
            save_point_cloud_ply(
                os.path.join(stage_dir, f"stage{stage}_need_inpaint_views_points.ply"),
                torch.cat(sel_pts))
            if self.priors.see3d is not None and self.priors.vae is not None:
                inpainted_all = self._run_see3d_inpaint(sel_warps, sel_masks, stage)
            else:
                inpainted_all = sel_warps
            inp_dir = os.path.join(stage_dir, "select-gs-inpainted")
            os.makedirs(inp_dir, exist_ok=True)
            for k, img in enumerate(inpainted_all):
                save_image_async(os.path.join(inp_dir, f"predict_warp_frame{k:06d}.png"), img)
            for k, img in enumerate(self._last_sr_preds or []):
                save_image_async(os.path.join(inp_dir, f"SR_predict_warp_frame{k:06d}.png"), img)

            # Depth lift: mono disparity aligned to the rendered depth inside
            # the visible mask, the rendered depth kept there.
            new_images = torch.stack(inpainted_all)
            disps = (self._mono_disparity(new_images)
                     if self.priors.depth_model is not None else None)
            new_depths, new_cams = [], []
            for k, vid in enumerate(sel):
                depth = depths_r[vid]
                if disps is not None:
                    lifted, _, _ = depth_linear_align(disps[k], depth, sel_masks[k])
                    depth = torch.where(sel_masks[k], depth, lifted)
                new_depths.append(depth)
                new_cams.append(camera_at(cand, vid))
            new_depths = torch.stack(new_depths)
            del maps_c, renders, alphas

            # Merge: grow the training set and record the stage's anchor ids.
            begin_idx = len(st.images)
            st.images = torch.cat([st.images, new_images])
            st.depths = torch.cat([st.depths, new_depths])
            st.cameras = stack_cameras([camera_at(st.cameras, i)
                                        for i in range(st.cameras.w2c.shape[0])] + new_cams)
            st.color_weights = torch.cat([st.color_weights,
                                          torch.full((len(sel),), 0.01, device=self.device)])
            st.normals, st.curvs = self._normals_curvs(st.cameras, st.depths)
            st.confidences = torch.ones_like(st.depths)
            self.render_chart_views_light()
            self.excavate_planes()
            anchor_ids = list(range(begin_idx, begin_idx + len(sel)))
            st.anchor_view_ids = anchor_ids
            with open(os.path.join(self.store.plane_root, "anchor_view_id.json"), "w") as f:
                json.dump(anchor_ids, f)
            all_inp = os.path.join(self.store.see3d_root, "inpainted_images")
            os.makedirs(all_inp, exist_ok=True)
            root = self.store.plane_root
            for k, gid in enumerate(anchor_ids):
                save_image_async(os.path.join(all_inp, f"predict_warp_frame{gid:06d}.png"),
                                 new_images[k])
                save_image_async(os.path.join(root, f"rgb_frame{gid:06d}.png"), new_images[k])
                save_depth_tiff_async(os.path.join(root, f"depth_frame{gid:06d}.tiff"),
                                      new_depths[k])
                save_npy_async(os.path.join(root, f"mono_normal_world_frame{gid:06d}.npy"),
                               st.normals[gid])
            flush_io()
            self._write_see3d_cameras(stage, new_cams)
            report["views"] = len(st.images)

    def _write_see3d_cameras(self, stage: int, new_cams):
        """The stage's camera archive and the cumulative merge, in the
        reference's npz schema: R_/T_/FoVx_/FoVy_/image_width_/image_height_
        per view, n_views and train_views."""
        st = self.state

        def cam_entries(d, i, cam):
            w2c = cam.w2c.detach().cpu().numpy()
            d[f"R_{i:06d}"] = w2c[:3, :3].T
            d[f"T_{i:06d}"] = w2c[:3, 3]
            W, H = int(cam.width), int(cam.height)
            d[f"FoVx_{i:06d}"] = 2.0 * math.atan(W / (2.0 * float(cam.fx)))
            d[f"FoVy_{i:06d}"] = 2.0 * math.atan(H / (2.0 * float(cam.fy)))
            d[f"image_width_{i:06d}"] = W
            d[f"image_height_{i:06d}"] = H

        stage_d: Dict = {"n_views": len(new_cams), "train_views": st.input_view_num}
        for i, cam in enumerate(new_cams):
            cam_entries(stage_d, i, cam)
        np.savez(os.path.join(self.store.see3d_root, f"stage{stage}_see3d_cameras.npz"),
                 **stage_d)
        cum_path = os.path.join(self.store.see3d_root, "see3d_cameras.npz")
        if os.path.exists(cum_path):
            cum = dict(np.load(cum_path))
            prev = int(cum["n_views"])
            os.remove(cum_path)
        else:
            cum, prev = {"train_views": st.input_view_num}, 0
        for i, cam in enumerate(new_cams):
            cam_entries(cum, prev + i, cam)
        cum["n_views"] = prev + len(new_cams)
        np.savez(cum_path, **cum)

    def render_chart_views_light(self):
        """Rebuild the pixel → point ids and the chart points after the view
        set grew."""
        st = self.state
        pid_maps, all_pts = [], []
        next_id = 1
        V, H, W = st.depths.shape
        for v in range(V):
            all_pts.append(camera_at(st.cameras, v).backproject(st.depths[v]).reshape(-1, 3))
            pid_maps.append(_point_ids(st.depths[v], next_id))
            next_id += H * W
        st.pixel_point_ids = pid_maps
        self._chart_points = torch.cat([all_pts[0].new_zeros((1, 3))] + all_pts)

    def _run_see3d_inpaint(self, warps, masks, stage: int) -> List[torch.Tensor]:
        """Every selected warp of the stage through the MV-UNet jointly, the
        input views pinned as references (`see3d_stage.run_see3d_inpaint`).
        Returns one inpainted (H, W, 3) image per warp."""
        outs, self._last_sr_preds = run_see3d_inpaint(
            self.priors, self.state.images, self.state.input_view_num, warps,
            [m.to(torch.float32) for m in masks], stage,
            mvd_resolution=self.cfg.mvd_resolution, group_size=self.cfg.see3d_group_size,
            super_resolution=self.cfg.see3d_super_resolution, device=self.device)
        return outs

    def _render_maps_batch(self, cameras: Camera, n_views: int,
                           keys=("render", "rend_alpha", "surf_depth"),
                           depth_ratio: float = 0.5) -> Dict[str, torch.Tensor]:
        """{key: (n_views, H, W[, C])} maps of the first n_views cameras, one
        render (one B1 launch on the cuda backend) per view, on the scene's
        device, the views fanned out over the device mesh when there is one
        (padded by repeating the last camera, the tail dropped). The
        distortion channel is computed only when asked for."""
        mesh = pmesh.fan_mesh(self.state.scene.device, n_views)
        if mesh is not None:
            with torch.no_grad():
                return pmesh.render_views(mesh, self.state.scene, cameras, n_views,
                                          backend=self.cfg.render_backend, keys=tuple(keys),
                                          depth_ratio=depth_ratio)
        cfg = RenderConfig(depth_ratio=depth_ratio, compute_distortion=bool(
            {"rend_dist", "dist_m1", "dist_m2"} & set(keys)))
        maps = {k: [] for k in keys}
        with torch.no_grad():
            for i in range(n_views):
                out = render(camera_at(cameras, i), self.state.scene, config=cfg,
                             backend=self.cfg.render_backend)
                for k in keys:
                    maps[k].append(out[k])
        return {k: torch.stack(v) for k, v in maps.items()}

    def dense_view_stage(self, dense_cameras: Camera):
        """Dense-view mode: render every dense view from the current model,
        lift mono depth aligned to the rendered depth outside the visible
        part (the rendered depth otherwise), replace the training set with
        the dense views and rebuild the plane inputs. The caller then runs
        refine_plane_depths and train_gaussians (no See3D)."""
        st = self.state
        with self._timed("dense_view_stage"):
            dense_cameras = dense_cameras.to(self.device)
            n = dense_cameras.w2c.shape[0]
            maps = self._render_maps_batch(dense_cameras, n,
                                           keys=("render", "rend_alpha", "surf_depth"),
                                           depth_ratio=0.5)
            imgs, depths, alphas = maps["render"], maps["surf_depth"].clone(), maps["rend_alpha"]
            if self.priors.depth_model is not None:
                disps = self._mono_disparity(imgs)
                for i in range(n):
                    vis = alphas[i] > 0.5
                    lifted, _, _ = depth_linear_align(disps[i], depths[i], vis)
                    depths[i] = torch.where(vis, depths[i], lifted)
            st.images = imgs
            st.depths = depths
            st.prior_depths = depths.clone()
            st.cameras = dense_cameras
            st.input_view_num = n
            w0 = 0.01 if self.cfg.downweight_input_view_color_loss else 1.0
            st.color_weights = torch.full((n,), w0, device=self.device)
            st.normals, st.curvs = self._normals_curvs(st.cameras, st.depths)
            st.confidences = torch.ones_like(st.depths)
            self.render_chart_views_light()
            self.excavate_planes()

    def _render_camera_batch(self, cameras: Camera, n_views: int, out_dir: str) -> torch.Tensor:
        """The first n_views cameras' renders, written to out_dir/{v:05d}.png
        (one B1 launch per view on the cuda backend), fanned out over the
        device mesh when there is one."""
        return render_camera_batch(self.state.scene, cameras, out_dir, self.cfg.render_backend,
                                   n_views=n_views,
                                   mesh=pmesh.fan_mesh(self.state.scene.device, n_views))

    def render_all(self, iteration: Optional[int] = None, include_test: bool = True):
        """Render the train views, and the held-out test views when a split
        is loaded, into `{split}/ours_{it}/renders`."""
        st = self.state
        it = iteration or self.cfg.train_iterations
        with self._timed("render_all"):
            renders = self._render_camera_batch(st.cameras, st.input_view_num,
                                                self.store.renders_dir("train", it))
            if include_test and st.test_cameras is not None:
                self._render_camera_batch(st.test_cameras, st.test_cameras.w2c.shape[0],
                                          self.store.renders_dir("test", it))
        return renders

    def extract_mesh(self):
        """The adaptive tetra mesh, or the multires TSDF mesh with its
        largest clusters kept, from the YAML config tree
        (configs/adaptive_tetrahedralization, configs/multiresolution_tsdf)."""
        st = self.state
        cfg = self.cfg
        with self._timed("extract_mesh"):
            if cfg.use_multires_tsdf:
                tcfg = load_config("multiresolution_tsdf", cfg.tsdf_config)
                mesh = extract_mesh_multires_tsdf(
                    st.scene, st.cameras,
                    factors=tuple(tcfg.get("multires_factors", cfg.multires_factors)),
                    resolution=cfg.tsdf_resolution, mesh_res=int(tcfg.get("mesh_res", 1024)),
                    depth_ratio=float(tcfg.get("depth_ratio", 1.0)), backend=cfg.render_backend)
                mesh = keep_largest_clusters(mesh,
                                             cluster_to_keep=int(tcfg.get("num_cluster", 50)))
            else:
                mcfg = mesh_config_from(
                    load_config("adaptive_tetrahedralization", cfg.tetra_config),
                    base=MeshExtractionConfig(downsample_ratio=cfg.tetra_downsample_ratio,
                                              backend=cfg.render_backend,
                                              use_interpolated_views=cfg.use_interpolated_views))
                mesh = extract_mesh_adaptive_tsdf(st.scene, st.cameras, mcfg)
            if cfg.use_mesh_filter:
                mesh = filter_mesh_by_edge_length(mesh)
            save_mesh_ply(os.path.join(
                self.store.meshes,
                f"tetra_mesh_binary_search_7_iter_{cfg.train_iterations}.ply"),
                mesh.vertices, mesh.faces, mesh.vertex_colors)
            return mesh

    def evaluate(self, gt_images=None, gt_mesh=None, iteration: Optional[int] = None,
                 lpips_model=None) -> Dict:
        """PSNR/SSIM/LPIPS and mesh metrics → result_iter_{it}.json/.txt, in
        the JAX package's schema: on the held-out split (`Average-*`,
        `test_views_num`) when one is loaded, on the train views against
        `gt_images`, and the mesh (extracted again) against `gt_mesh`
        (vertices, faces). Without LPIPS weights the VGG is a random init,
        flagged `LPIPS-uncalibrated`."""
        st = self.state
        it = iteration or self.cfg.train_iterations
        results: Dict = {}
        with self._timed("evaluate"):
            lp = (lpips_model if lpips_model is not None
                  else self.priors.lpips or LPIPS(device=self.device))
            if not getattr(lp, "calibrated", True):
                results["LPIPS-uncalibrated"] = True
            if st.test_images is not None and st.test_cameras is not None:
                n_test = len(st.test_images)
                test_renders = self._render_camera_batch(st.test_cameras, n_test,
                                                         self.store.renders_dir("test", it))
                m = evaluate_images(test_renders, st.test_images, lpips_model=lp)
                results["test_views_num"] = n_test
                results["Average-PSNR"] = round(m["PSNR"], 5)
                results["Average-SSIM"] = round(m["SSIM"], 5)
                results["Average-LPIPS"] = round(m["LPIPS"], 5)
            if gt_images is not None:
                renders = self.render_all(it, include_test=False)
                n = min(len(renders), len(gt_images))
                results.update(evaluate_images(renders[:n], self._tensor(gt_images)[:n],
                                               lpips_model=lp))
            if gt_mesh is not None:
                mesh = self.extract_mesh()
                results.update(evaluate_mesh(mesh.vertices, mesh.faces, _host(gt_mesh[0]),
                                             _host(gt_mesh[1])))
        write_results(self.cfg.output_path, it, results)
        return results

    # -------------------------------------------------------------- re-entry
    def stage_done(self) -> Dict[str, bool]:
        """Which stages the artifact store holds the output of, keyed as the
        JAX package keys them (the reference's file idempotence: a stage
        script reruns from its upstream files, SURVEY §5.3)."""
        pr = self.store.plane_root
        done = {
            "sfm": os.path.exists(os.path.join(self.store.sparse, "cameras.bin")),
            "charts": os.path.exists(self.store.charts),
            "chart_views": os.path.exists(os.path.join(pr, "visibility_frame000000.npy")),
            "planes": os.path.exists(os.path.join(pr, "global_3Dplane_ID_dict.json")),
            "refine": os.path.exists(os.path.join(pr, "refine_depth_frame000000.tiff")),
            "train": os.path.exists(self._ply_path()),
        }
        for k in range(1, self.cfg.n_see3d_stages + 1):
            done[f"see3d_{k}"] = os.path.exists(os.path.join(
                self.store.see3d_root, f"stage{k}_see3d_cameras.npz"))
        return done

    def _ply_path(self) -> str:
        return os.path.join(self.store.gaussians, "point_cloud",
                            f"iteration_{self.cfg.train_iterations}", "point_cloud.ply")

    def resume_from_artifacts(self) -> Dict[str, bool]:
        """Rebuild the state, on the pipeline's device, from the artifact
        store as far as its files go, and return `stage_done`: the COLMAP
        cameras and the cumulative See3D cameras, the views' images, refined
        (else chart) depths, prior depths, world normals (curvatures derived),
        confidence maps, plane masks, the global plane dict and the anchor
        views, the colour weights, the pixel → point ids, the latest
        `point_cloud.ply` and the charts' scale factor."""
        from g4splat_torch.io.images import load_depth_tiff, load_image, load_mask_png
        from g4splat_torch.io.ply import load_gaussian_ply

        st = self.state
        pr = self.store.plane_root
        done = self.stage_done()
        if not done["sfm"]:
            return done
        cams_meta, imgs_meta, _ = colmap_io.read_model(self.store.sparse)
        cam_list = [c for _, c in colmap_io.to_framework_cameras(cams_meta, imgs_meta,
                                                                  device=self.device)]
        st.input_view_num = len(cam_list)
        cum_path = os.path.join(self.store.see3d_root, "see3d_cameras.npz")
        if os.path.exists(cum_path):
            cum = dict(np.load(cum_path))
            for i in range(int(cum["n_views"])):
                Wn, Hn = int(cum[f"image_width_{i:06d}"]), int(cum[f"image_height_{i:06d}"])
                fx = Wn / (2.0 * math.tan(float(cum[f"FoVx_{i:06d}"]) / 2))
                fy = Hn / (2.0 * math.tan(float(cum[f"FoVy_{i:06d}"]) / 2))
                w2c = np.eye(4, dtype=np.float32)
                w2c[:3, :3] = np.asarray(cum[f"R_{i:06d}"]).T
                w2c[:3, 3] = np.asarray(cum[f"T_{i:06d}"])
                cam_list.append(make_camera(w2c, fx, fy, (Wn - 1) / 2, (Hn - 1) / 2, Wn, Hn,
                                            device=self.device))
        st.cameras = stack_cameras(cam_list)
        V = len(cam_list)

        def per_view(fmt, loader):
            paths = [os.path.join(pr, fmt.format(v)) for v in range(V)]
            if all(os.path.exists(p) for p in paths):
                return self._tensor(np.stack([loader(p) for p in paths]))
            return None

        st.images = per_view("rgb_frame{:06d}.png", load_image)
        refined = per_view("refine_depth_frame{:06d}.tiff", load_depth_tiff)
        st.depths = (refined if refined is not None
                     else per_view("depth_frame{:06d}.tiff", load_depth_tiff))
        mono = per_view("mono_depth_frame{:06d}.tiff", load_depth_tiff)
        st.prior_depths = mono if mono is not None else (
            st.depths.clone() if st.depths is not None else None)
        st.normals = per_view("mono_normal_world_frame{:06d}.npy", np.load)
        if st.normals is not None:
            st.curvs = torch.stack([normal_to_curvature(n) for n in st.normals])
        conf = per_view("confident_map_frame{:06d}.png",
                        lambda p: load_mask_png(p).astype(np.float32))
        if conf is not None:
            st.confidences = conf
        elif st.depths is not None:
            st.confidences = torch.ones_like(st.depths)
        mask_paths = [os.path.join(pr, f"plane_mask_frame{v:06d}.npy") for v in range(V)]
        if all(os.path.exists(p) for p in mask_paths):
            st.plane_masks = [np.load(p) for p in mask_paths]
            gp = os.path.join(pr, "global_3Dplane_ID_dict.json")
            if os.path.exists(gp):
                with open(gp) as f:
                    st.global_plane_dict = {int(k): [tuple(x) for x in v]
                                            for k, v in json.load(f).items()}
        w0 = 0.01 if self.cfg.downweight_input_view_color_loss else 1.0
        st.color_weights = torch.cat([
            torch.full((st.input_view_num,), w0, device=self.device),
            torch.full((V - st.input_view_num,), 0.01, device=self.device)])
        aj = os.path.join(pr, "anchor_view_id.json")
        if os.path.exists(aj):
            with open(aj) as f:
                st.anchor_view_ids = [int(i) for i in json.load(f)]
        if st.depths is not None:
            self.render_chart_views_light()
        if os.path.exists(self._ply_path()):
            st.scene = load_gaussian_ply(self._ply_path(), device=self.device)
        if os.path.exists(self.store.charts):
            with np.load(self.store.charts) as data:
                if "scale_factor" in data:
                    st.scale_factor = float(data["scale_factor"])
        return done

    # ------------------------------------------------------------------ run
    def run(self, images, cameras: Optional[Camera] = None, gt_images=None, gt_mesh=None,
            dense_cameras: Optional[Camera] = None, test_images=None,
            test_cameras: Optional[Camera] = None) -> Dict:
        """The whole pipeline, from posed (or unposed) images to the
        results, in the JAX package's order."""
        t0 = time.time()
        self.load_inputs(images, cameras, test_images=test_images, test_cameras=test_cameras)
        self.run_sfm()
        self.align_charts()
        self.render_chart_views()
        self.excavate_planes()
        self.refine_plane_depths()
        self.train_gaussians()
        if self.cfg.use_dense_view:
            assert dense_cameras is not None, "dense-view mode needs cameras"
            self.dense_view_stage(dense_cameras)
            self.refine_plane_depths()
            pcd = os.path.join(self.store.gaussians, "point_cloud")
            if os.path.exists(pcd):
                os.rename(pcd, pcd + "-chart-views")
            self.train_gaussians()
        else:
            for stage in range(1, self.cfg.n_see3d_stages + 1):
                self.see3d_stage(stage)
                # Stage 3 takes the anchor-restricted colour harmonisation.
                self.refine_plane_depths(use_anchor_colors=(stage == 3))
                # Snapshot: point_cloud → point_cloud-{ori,s1,s2}.
                pcd = os.path.join(self.store.gaussians, "point_cloud")
                if os.path.exists(pcd):
                    tag = {1: "ori", 2: "s1", 3: "s2"}.get(stage, f"s{stage - 1}")
                    os.rename(pcd, pcd + f"-{tag}")
                self.train_gaussians()
        self.extract_mesh()
        results = self.evaluate(gt_images=gt_images, gt_mesh=gt_mesh)
        self.timings["total"] = time.time() - t0
        print(f"[pipeline] total: {self.timings['total']:.1f}s", flush=True)
        return results
