"""One See3D loop of the port's `G4SplatPipeline` against the JAX package's
on the CPU (the `tiled` backend on both sides).

The scene is box_room(300) seen by `inward_cameras` (3 at 48×36, the same
cameras in both packages); the input images and
the depths that stand in for the chart depths are the port's renders of it,
fed to both pipelines as numpy. `PipelineConfig` is the default save
`select_inpaint_num` 2, `vis_grid_resolution` 32 and 10 training
iterations. The depth model is the same stand-in on both sides (disparity
0.2 + grey level): DepthAnything V2 on random weights gives a near-constant
disparity, whose affine fit to the rendered depth is ill-conditioned, and
its own parity is test_torch_depth_anything.py's. `_run_see3d_inpaint` is
replaced on both sides by the same deterministic function of the warps and
masks (its own parity is test_torch_see3d_stage.py), and `Trainer` by one
that only sets every live splat's opacity to sigmoid(4) (training is
test_torch_train.py's): each round renders its init's surfels, and the
TrainConfig each package builds from the schedule is compared.

The loop runs `run()`'s order: render_chart_views, excavate_planes,
refine_plane_depths, train_gaussians, then for stages 1-3 see3d_stage(k),
refine_plane_depths(k == 3) and train_gaussians. After every method the
states are compared: images, depths and confidences within MAP_TOL (1e-4),
normals and curvatures within NORMAL_TOL (1e-3), plane masks identical, the global plane dict equal,
the fitted planes' centres within MAP_TOL, each stage's candidates,
selected ids and anchor ids identical, the init parts within MAP_TOL, and
the same file names written. Where a view sees past the room its depth is
0: the port gives such a pixel no chart point (point id 0) and drops its
faces from the init (ROADMAP C12), and the JAX pipeline is given the same
rule (its point ids zeroed there, its init under the mask depth > 0).

Every `_render_maps_batch` call of the JAX pipeline runs its own renderer
(`view_parallel_render`, `tiled`) and is held against the port's
`_render_maps_batch` on the same scene, cameras, keys and depth ratio. Over
the call's views, at most MAP_SHARE (2e-2) of the pixels may differ by more
than MAP_TOL in any map, at most FLIP_SHARE (1e-3) may flip alpha > 0.5,
and each candidate's none-visible rate agrees within RATE_TOL (1e-3, under
2 pixels of a 48×36 view). A wrong view, key, depth ratio or scene moves
most covered pixels. The two tiled rasterizers round the ray-plane
intersection of surfels seen edge-on differently, which moves single
pixels (up to 0.19 in value), and they order surfels at equal view depth
(a wall seen head-on) by depths that differ in the last bit, which decides
the colour of such a region where the surfels of two views disagree: 0.54 %
of one stage-3 sweep's pixels, up to 0.054. The port's maps then go on in both
pipelines, so that such a pixel does not spread into the inpainted images
and the states after it.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.cluster
import torch

import g4splat_tpu.pipeline.novel_views as JN
import g4splat_tpu.pipeline.orchestrator as JO
import g4splat_tpu.train.trainer as JT
import g4splat_torch.pipeline.orchestrator as TO
from g4splat_torch.convert import camera_from, scene_from
from g4splat_torch.ops.rasterize import render
from g4splat_torch.ops.rasterize_common import RenderConfig
from g4splat_torch.core.cameras import camera_at
from g4splat_torch.ops.kmeans import kmeans
from g4splat_torch.eval.synthetic import inward_cameras
from g4splat_torch.pipeline.novel_views import none_visible_rate_from_alpha
from g4splat_tpu.core import cameras as jcam
from g4splat_tpu.eval import synthetic as jsyn

MAP_TOL = 1e-4
# Normals are normalized finite differences of backprojected depths, and the
# curvature sums their 4-neighbour differences: fp32 rounding of two nearly
# equal neighbouring depths moves them by more than it moves the depths.
NORMAL_TOL = 1e-3
MAP_SHARE, FLIP_SHARE, RATE_TOL = 2e-2, 1e-3, 1e-3
DENSITY, VIEWS = 300, (3, 48, 36)
CONFIG = dict(select_inpaint_num=2, vis_grid_resolution=32, train_iterations=10,
              gaussian_capacity=8000, none_visible_high=0.95,
              render_backend="tiled")


class GreyDisparity:
    """A stand-in depth model: disparity 0.2 + the pixel's grey level."""

    def infer_images(self, images, mesh=None):
        return 0.2 + images.mean(-1)


class OpaqueTrainer:
    """Stands for `Trainer` in both packages: its scene is the init's, every
    live splat at opacity sigmoid(4); it records the TrainConfig it got."""

    configs = []

    def __init__(self, scene, cameras, views, cfg, **kw):
        where = torch.where if torch.is_tensor(scene.opacity_raw) else jnp.where
        self.scene = scene.replace(opacity_raw=where(scene.alive[:, None], 4.0,
                                                     scene.opacity_raw))
        OpaqueTrainer.configs.append(cfg)

    def train(self, *a, **kw):
        return []


class PortKMeans:
    """`sklearn.cluster.KMeans` for the JAX side, computed by the port's
    k-means (see the module docstring)."""

    def __init__(self, n_clusters, random_state=0, n_init=1):
        self.n_clusters, self.seed = n_clusters, random_state

    def fit(self, X):
        labels, centers = kmeans(torch.from_numpy(np.asarray(X, np.float32)),
                                 self.n_clusters, seed=self.seed)
        self.labels_, self.cluster_centers_ = labels.numpy().astype(np.int32), centers.numpy()
        return self


def fake_inpaint(warp, mask, stage, lib):
    """Visible pixels kept, the rest a stage-dependent horizontal ramp."""
    H, W = warp.shape[:2]
    if lib is np:
        m = mask[..., None].astype(np.float32)
        ramp = np.arange(W, dtype=np.float32) / np.float32(W)
    else:
        m = mask.to(torch.float32)[..., None]
        ramp = torch.arange(W, dtype=torch.float32) / W
    fill = (0.2 + 0.1 * stage) + 0.5 * ramp[None, :, None] * lib.ones_like(warp)
    return warp * m + (1 - m) * fill


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    js, _ = jsyn.box_room(DENSITY)
    ts = scene_from(js, device="cpu")
    tc = inward_cameras(*VIEWS, device="cpu")
    jc = jcam.stack_cameras([jcam.make_camera(*(getattr(camera_at(tc, v), k).numpy() for k in
                                                ("w2c", "fx", "fy", "cx", "cy")), *VIEWS[1:])
                             for v in range(VIEWS[0])])
    with torch.no_grad():
        outs = [render(camera_at(tc, v), ts, config=RenderConfig(depth_ratio=0.5),
                       backend="tiled") for v in range(VIEWS[0])]
    images = np.stack([o["render"].clamp(0, 1).numpy() for o in outs])
    depths = np.stack([o["surf_depth"].numpy() for o in outs])
    assert (depths <= 0).any()

    jroot, troot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jp = JO.G4SplatPipeline(JO.PipelineConfig(output_path=str(jroot), **CONFIG),
                            JO.Priors(depth_model=GreyDisparity(), see3d=object(), vae=object()))
    tp = TO.G4SplatPipeline(TO.PipelineConfig(output_path=str(troot), **CONFIG),
                            TO.Priors(depth_model=GreyDisparity(), see3d=object(), vae=object()),
                            device="cpu")
    jp._run_see3d_inpaint = lambda w, m, k: [fake_inpaint(a, b, k, np) for a, b in zip(w, m)]
    tp._run_see3d_inpaint = lambda w, m, k: [fake_inpaint(a, b, k, torch) for a, b in zip(w, m)]
    jp.load_inputs(images, jc)
    tp.load_inputs(images, tc)
    for p in (jp, tp):
        p.state.depths = p._tensor(depths) if p is tp else depths.copy()
        p.state.prior_depths = p._tensor(depths) if p is tp else depths.copy()

    inits = {}

    def spy(mod, key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            inits.setdefault(key, []).append({k: np.asarray(v) for k, v in out.items()})
            return out
        return wrapped

    def without_depthless_pixels(fn):
        """The JAX init under the visibility mask depth > 0, as the port drops
        the faces of pixels without depth (ROADMAP C12)."""
        def wrapped(cameras, depths, images, **kw):
            assert kw.get("visibility_masks") is None
            return fn(cameras, depths, images, visibility_masks=np.asarray(depths) > 0, **kw)
        return wrapped

    def point_ids_with_depth(fn):
        """The JAX method, then point id 0 wherever the depth is ≤ 0, as the
        port gives such pixels no chart point (ROADMAP C12)."""
        def wrapped(self):
            fn(self)
            for pid, d in zip(self.state.pixel_point_ids, np.asarray(self.state.depths)):
                pid[d <= 0] = 0
        return wrapped

    mp = pytest.MonkeyPatch()
    jax_render = JO.G4SplatPipeline._render_maps_batch
    render_checks = []

    def checked_render(self, cameras, n_views, keys=("render", "rend_alpha", "surf_depth"),
                       depth_ratio=0.5):
        own = jax_render(self, cameras, n_views, keys, depth_ratio)
        maps = TO.G4SplatPipeline._render_maps_batch(
            types.SimpleNamespace(state=types.SimpleNamespace(
                scene=scene_from(self.state.scene, device="cpu")), cfg=self.cfg),
            camera_from(cameras, device="cpu"), n_views, keys, depth_ratio)
        maps = {k: v.numpy() for k, v in maps.items()}
        assert sorted(own) == sorted(maps) == sorted(keys)
        for k in keys:
            a, b = own[k], maps[k]
            assert a.shape == b.shape and a.shape[0] == n_views, k
            bad = np.abs(a - b) > MAP_TOL
            assert (bad.any(-1) if bad.ndim == 4 else bad).mean() <= MAP_SHARE, k
        if "rend_alpha" in keys:
            a, b = own["rend_alpha"] > 0.5, maps["rend_alpha"] > 0.5
            assert (a != b).mean() <= FLIP_SHARE
            rates = [JN.none_visible_rate_from_alpha(x) for x in own["rend_alpha"]]
            port_rates = [none_visible_rate_from_alpha(x) for x in maps["rend_alpha"]]
            assert np.abs(np.subtract(rates, port_rates)).max() <= RATE_TOL
        render_checks.append(keys)
        return maps

    mp.setattr(JO.G4SplatPipeline, "_render_maps_batch", checked_render)
    mp.setattr(sklearn.cluster, "KMeans", PortKMeans)
    mp.setattr(JT, "Trainer", OpaqueTrainer)
    mp.setattr(TO, "Trainer", OpaqueTrainer)
    import g4splat_tpu.pipeline.gaussian_init as JG
    mp.setattr(JG, "init_from_manifold_meshes",
               spy(JG, "jax", without_depthless_pixels(JG.init_from_manifold_meshes)))
    for name in ("render_chart_views", "render_chart_views_light"):
        mp.setattr(JO.G4SplatPipeline, name,
                   point_ids_with_depth(getattr(JO.G4SplatPipeline, name)))
    mp.setattr(TO, "init_from_manifold_meshes",
               spy(TO, "port", TO.init_from_manifold_meshes))
    yield jp, tp, jroot, troot, inits, render_checks
    mp.undo()


def host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def compare(jp, tp, what):
    js, ts = jp.state, tp.state
    for k in ("images", "depths", "normals", "curvs", "confidences"):
        a, b = getattr(js, k), getattr(ts, k)
        if a is None:
            assert b is None, (what, k)
            continue
        a, b = np.asarray(a, np.float32), host(b).astype(np.float32)
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        d = np.abs(a - b).max()
        assert d <= (NORMAL_TOL if k in ("normals", "curvs") else MAP_TOL), (what, k, d)
    assert len(js.plane_masks) == len(ts.plane_masks)
    for a, b in zip(js.plane_masks, ts.plane_masks):
        assert np.array_equal(a, b), what
    assert len(js.pixel_point_ids) == len(ts.pixel_point_ids), what
    for a, b in zip(js.pixel_point_ids, ts.pixel_point_ids):
        assert np.array_equal(a, b), what
    assert js.global_plane_dict == ts.global_plane_dict, what
    assert js.anchor_view_ids == ts.anchor_view_ids, what
    assert len(js.fitted_planes) == len(ts.fitted_planes), what
    for a, b in zip(js.fitted_planes, ts.fitted_planes):
        assert a["id"] == b["id"] and np.abs(a["center"] - b["center"]).max() <= MAP_TOL, what
    np.testing.assert_allclose(host(ts.cameras.w2c), np.asarray(js.cameras.w2c), atol=1e-5)
    np.testing.assert_allclose(host(ts.color_weights), np.asarray(js.color_weights))


def sync(jp, tp):
    """The port's state (and chart points) set to the JAX pipeline's."""
    js, ts = jp.state, tp.state
    for k in ("images", "depths", "prior_depths", "normals", "curvs", "confidences",
              "color_weights"):
        v = getattr(js, k)
        setattr(ts, k, None if v is None else torch.tensor(np.array(v, np.float32)))
    ts.cameras = camera_from(js.cameras, device="cpu")
    ts.scene = None if js.scene is None else scene_from(js.scene, device="cpu")
    ts.input_view_num = js.input_view_num
    ts.plane_masks = [np.array(m) for m in js.plane_masks]
    ts.pixel_point_ids = [np.array(m) for m in js.pixel_point_ids]
    ts.global_plane_points = [np.array(p) for p in js.global_plane_points]
    ts.global_plane_dict = {k: list(v) for k, v in js.global_plane_dict.items()}
    ts.fitted_planes = [dict(p) for p in js.fitted_planes]
    ts.anchor_view_ids = list(js.anchor_view_ids)
    if hasattr(jp, "_chart_points"):
        tp._chart_points = torch.tensor(np.array(jp._chart_points, np.float32))


def written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_see3d_loop_matches_jax(loop):
    jp, tp, jroot, troot, inits, render_checks = loop
    steps = [("render_chart_views", ()), ("excavate_planes", ()),
             ("refine_plane_depths", ()), ("train_gaussians", ())]
    for k in (1, 2, 3):
        steps += [("see3d_stage", (k,)), ("refine_plane_depths", (k == 3,)),
                  ("train_gaussians", ())]
    for name, args in steps:
        sync(jp, tp)
        getattr(jp, name)(*args)
        getattr(tp, name)(*args)
        compare(jp, tp, f"{name}{args}")
        if name == "train_gaussians":
            jcfg, tcfg = OpaqueTrainer.configs[-2:]
            for f in ("iterations", "densify_until_iter", "opacity_reset_interval",
                      "normal_consistency_from", "distortion_from", "use_mip_filter",
                      "depth_ratio", "spatial_lr_scale", "raster_compact_width"):
                assert getattr(jcfg, f) == pytest.approx(getattr(tcfg, f)), f
            assert tcfg.backend == "tiled"
            a, b = inits["jax"][-1], inits["port"][-1]
            for key in ("means", "scales", "quaternions", "colors"):
                assert a[key].shape == b[key].shape, key
                d = np.abs(a[key] - b[key])
                if key == "quaternions":    # q and -q: one rotation (w ≈ 0 rows)
                    d = np.minimum(d, np.abs(a[key] + b[key]))
                assert d.max() <= MAP_TOL, key
            np.testing.assert_allclose(host(tp.state.scene.xyz), np.asarray(jp.state.scene.xyz),
                                       atol=MAP_TOL)
    assert len(tp.state.images) == VIEWS[0] + 3 * CONFIG["select_inpaint_num"]
    assert tp.state.anchor_view_ids == [7, 8]
    assert written(jroot) == written(troot)
    # Each stage's train views and candidate sweep, held against JAX's maps.
    assert len(render_checks) == 6 and sum("rend_alpha" in k for k in render_checks) == 3
    cum = np.load(os.path.join(troot, "sfm", "see3d_render", "see3d_cameras.npz"))
    assert int(cum["n_views"]) == 3 * CONFIG["select_inpaint_num"]
