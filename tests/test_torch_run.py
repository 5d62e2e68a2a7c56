"""The port's `G4SplatPipeline.run()` alone, end to end on the CPU, on
test_torch_pipeline_run.py's scene, source tree, MASt3R params and YAML
overlays: view 2 held out, the depth model, See3D's inpainting and the
trainer replaced by test_torch_orchestrator.py's stand-ins (training is
test_torch_train.py's; the stand-in sets every live splat of the init to
opacity sigmoid(4)), one See3D stage and the multires mesh. It keeps the JAX package's stage order, its
file names (the front end's, held against the JAX package's in
test_torch_pipeline_run.py; the point_cloud-ori snapshot; renders, mesh and
results) and its result keys (the evaluate function's parity is
test_torch_eval.py's); then `dense_view_stage` runs on the trained scene.
"""

import json

import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.orchestrator as TO
from g4splat_torch.core.cameras import camera_at
from g4splat_torch.core.cameras import stack_cameras as stack_port_cameras
from test_torch_pipeline_run import (CONFIG, RES, mast3r_pair, scene_and_cameras, source_tree,
                                     written)
from test_torch_pipeline_run import patched  # noqa: F401  (the YAML overlays, a fixture)

# The front end's files with two train views, as the JAX package writes them
# (test_torch_pipeline_run.py::test_sfm_files_match_jax).
SFM_FILES = {f"sfm/{t}/0/{n}.{e}" for t in ("sparse", "all-sparse", "dense-view-sparse")
             for n in ("cameras", "images", "points3D") for e in ("bin", "txt")} | {
    "sfm/points.ply", "sfm/cameras.json", "sfm/charts_data.npz",
    "sfm/pointmaps/frame_000000.json", "sfm/pointmaps/frame_000001.json"}

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



class GreyDisparity:
    def infer_images(self, images, mesh=None):
        return 0.2 + images.mean(-1)


def fake_inpaint(warp, mask, stage):
    m = mask.to(torch.float32)[..., None]
    ramp = torch.arange(warp.shape[1], dtype=torch.float32) / warp.shape[1]
    return warp * m + (1 - m) * ((0.2 + 0.1 * stage) + 0.5 * ramp[None, :, None])


class OpaqueTrainer:
    def __init__(self, scene, cameras, views, cfg, **kw):
        self.scene = scene.replace(opacity_raw=torch.where(scene.alive[:, None], 4.0,
                                                           scene.opacity_raw))

    def train(self, *a, **kw):
        return []


def test_run_end_to_end(patched, tmp_path, monkeypatch):
    monkeypatch.setattr(TO, "Trainer", OpaqueTrainer)
    images, jc, tc = scene_and_cameras()
    src = source_tree(str(tmp_path / "in"), jc)
    tm, _ = mast3r_pair()
    out = tmp_path / "out"
    cfg = TO.PipelineConfig(source_path=src, output_path=str(out),
                            eval_split=[2], n_see3d_stages=1, select_inpaint_num=2,
                            none_visible_high=0.95, use_multires_tsdf=True, tsdf_resolution=40,
                            gaussian_capacity=4000, mvd_resolution=None, **CONFIG)
    tp = TO.G4SplatPipeline(cfg, TO.Priors(mast3r=tm, depth_model=GreyDisparity(),
                                           see3d=object(), vae=object()), device="cpu")
    tp._run_see3d_inpaint = lambda w, m, k: [fake_inpaint(a, b, k) for a, b in zip(w, m)]
    order = []
    for name in ("run_sfm", "align_charts", "render_chart_views", "excavate_planes",
                 "refine_plane_depths", "train_gaussians", "see3d_stage", "extract_mesh",
                 "evaluate"):
        fn = getattr(tp, name)
        setattr(tp, name, lambda *a, _fn=fn, _n=name, **kw: (order.append(_n), _fn(*a, **kw))[1])
    res = tp.run(images, tc, gt_images=images[:2])
    assert order == ["run_sfm", "align_charts", "render_chart_views", "excavate_planes",
                     "refine_plane_depths", "train_gaussians", "see3d_stage", "excavate_planes",
                     "refine_plane_depths", "train_gaussians", "extract_mesh", "evaluate"]
    keys = ["LPIPS-uncalibrated", "test_views_num", "Average-PSNR", "Average-SSIM",
            "Average-LPIPS", "PSNR", "SSIM", "LPIPS"]
    assert list(res) == keys and res["test_views_num"] == 1
    assert all(np.isfinite(v) for v in res.values())
    assert list(json.load(open(out / "result_iter_10.json"))) == keys
    names = set(written(str(out)))
    assert SFM_FILES <= names
    for f in ("result_iter_10.txt", "free_gaussians/point_cloud-ori/iteration_10/point_cloud.ply",
              "free_gaussians/point_cloud/iteration_10/point_cloud.ply",
              "free_gaussians/test/ours_10/renders/00000.png",
              "tetra_meshes/tetra_mesh_binary_search_7_iter_10.ply",
              "sfm/see3d_render/stage1/select-gs-inpainted/predict_warp_frame000000.png"):
        assert f in names, f
    assert len(tp.state.images) > 2 and tp.state.input_view_num == 2

    # Dense-view mode's stage on the trained scene: the rendered dense views,
    # their depths lifted outside the covered part, replace the training set.
    # (The train views: a view the scene does not cover would have no pixel to
    # fit the lift to.)
    dense = stack_port_cameras([camera_at(tc, v) for v in (1, 0)])
    tp.dense_view_stage(dense)
    st = tp.state
    assert st.input_view_num == 2 and st.images.shape == (2, RES, RES, 3)
    assert bool(torch.isfinite(st.depths).all()) and len(st.plane_masks) == 2
    assert len(st.pixel_point_ids) == 2 and st.normals.shape == (2, RES, RES, 3)
    np.testing.assert_array_equal(st.cameras.w2c.numpy(), dense.w2c.numpy())
