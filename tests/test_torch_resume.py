"""`G4SplatPipeline.stage_done` and `resume_from_artifacts` of the port
against the JAX package's, on the CPU.

- The port's posed tail (posed bootstrap, the rendered depths as chart
  depths, render_chart_views, excavate_planes, refine_plane_depths,
  train_gaussians at 5 steps on the `cuda` backend's plain versions, 4000
  slots) on tests/test_pipeline.py's card
  scene drawn by the port: a fresh port pipeline resumes it, checked as
  tests/test_pipeline.py::test_resume_from_artifacts checks (cameras within
  1e-5, images within 1/255, depths, plane masks, num_alive), and renders a
  view of the resumed scene.
- The same store with a See3D stage's output added (two novel cameras in
  `see3d_cameras.npz`, their per-view files, `anchor_view_id.json`): the
  JAX package's `resume_from_artifacts` and the port's give the same
  `stage_done` map, cameras (w2c within 1e-6, intrinsics exact), images,
  depths, prior depths, normals, confidences, colour weights, plane masks,
  plane dict, anchor views and scale factor, exactly; the curvatures within
  1e-6 (the same matcha stencil in float32); the scene's buffers exactly.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.orchestrator as TO
import g4splat_tpu.pipeline.orchestrator as JO
from g4splat_torch.core.cameras import camera_at, lookat_camera, stack_cameras
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render

V, RES, ITERS = 3, 48, 5
PER_VIEW = ("rgb_frame{:06d}.png", "depth_frame{:06d}.tiff", "refine_depth_frame{:06d}.tiff",
            "mono_depth_frame{:06d}.tiff", "mono_normal_world_frame{:06d}.npy",
            "confident_map_frame{:06d}.png", "plane_mask_frame{:06d}.npy")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the module's fixtures and tests: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def card_camera(a):
    return lookat_camera([2.2 * np.sin(a), 0.25, -2.2 * np.cos(a)], [0, 0, 0], [0, -1, 0],
                         fx=float(RES), fy=float(RES), width=RES, height=RES, device="cpu")


def card_room():
    """tests/test_pipeline.py::synthetic_room drawn by the port: 400 coloured
    splats on a plane, 3 cameras at 48², the far plane filled at 2.2."""
    rng = np.random.RandomState(0)
    n = 400
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.zeros((n, 1))], 1).astype(np.float32)
    scene = GaussianScene.from_points(pts, rng.rand(n, 3).astype(np.float32),
                                      scales=np.full(n, 0.08, np.float32), initial_opacity=0.9,
                                      device="cpu")
    cams = stack_cameras([card_camera((i - (V - 1) / 2) * 0.35) for i in range(V)])
    with torch.no_grad():
        outs = [render(camera_at(cams, v), scene, backend="tiled") for v in range(V)]
    depths = torch.stack([o["surf_depth"] for o in outs])
    depths[depths <= 0] = 2.2
    return cams, torch.stack([o["render"] for o in outs]), depths


def config(out, cls, backend="tiled"):
    return cls(output_path=out, render_backend=backend, sfm_config="posed",
               train_iterations=ITERS, vis_grid_resolution=0, gaussian_capacity=4000)


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("resume") / "out")
    cams, images, depths = card_room()
    pipe = TO.G4SplatPipeline(config(out, TO.PipelineConfig, "cuda"), TO.Priors(),
                              device="cpu")
    pipe.load_inputs(images, cams)
    pipe.run_sfm()
    pipe.state.depths = depths.clone()
    pipe.state.prior_depths = depths.clone()
    pipe.render_chart_views()
    pipe.excavate_planes()
    pipe.refine_plane_depths()
    pipe.train_gaussians()
    return out, pipe


def test_resume_rebuilds_the_run(finished):
    out, pipe = finished
    fresh = TO.G4SplatPipeline(config(out, TO.PipelineConfig), TO.Priors(), device="cpu")
    done = fresh.resume_from_artifacts()
    assert done["sfm"] and done["chart_views"] and done["planes"]
    assert done["refine"] and done["train"] and not done["charts"]
    assert not done["see3d_1"]
    st, ref = fresh.state, pipe.state
    assert st.input_view_num == V
    torch.testing.assert_close(st.images, ref.images, atol=1 / 255, rtol=0)
    torch.testing.assert_close(st.depths, ref.depths, rtol=1e-5, atol=0)
    torch.testing.assert_close(st.cameras.w2c, ref.cameras.w2c, atol=1e-5, rtol=0)
    assert len(st.plane_masks) == V
    assert all(np.array_equal(a, b) for a, b in zip(st.plane_masks, ref.plane_masks))
    assert st.global_plane_dict == {k: [tuple(x) for x in v]
                                    for k, v in ref.global_plane_dict.items()}
    assert int(st.scene.num_alive) == int(ref.scene.num_alive)
    alive = ref.scene.alive
    assert torch.equal(st.scene.xyz[:int(alive.sum())], ref.scene.xyz[alive])
    out0 = render(camera_at(st.cameras, 0), st.scene, backend="tiled")
    assert torch.isfinite(out0["render"]).all()


def add_see3d_stage(out, pipe):
    """Two novel cameras in the stage-1 and cumulative camera archives,
    each with views 0 and 1's per-view files, and the anchor views."""
    novel = [card_camera(a) for a in (0.6, -0.6)]
    pipe.store = TO.ArtifactStore(out)
    pipe._write_see3d_cameras(1, novel)
    pr = pipe.store.plane_root
    for k in range(2):
        for fmt in PER_VIEW:
            shutil.copy(os.path.join(pr, fmt.format(k)), os.path.join(pr, fmt.format(V + k)))
    with open(os.path.join(pr, "anchor_view_id.json"), "w") as f:
        f.write(f"[{V}, {V + 1}]")


def test_resume_matches_jax(finished, tmp_path):
    src, pipe = finished
    out = str(tmp_path / "out")
    shutil.copytree(src, out)
    add_see3d_stage(out, pipe)
    tp = TO.G4SplatPipeline(config(out, TO.PipelineConfig), TO.Priors(), device="cpu")
    jp = JO.G4SplatPipeline(config(out, JO.PipelineConfig), JO.Priors())
    done = tp.resume_from_artifacts()
    assert done == jp.resume_from_artifacts() and done["see3d_1"]
    t, j = tp.state, jp.state
    assert t.input_view_num == j.input_view_num == V
    assert t.cameras.w2c.shape[0] == V + 2
    np.testing.assert_allclose(t.cameras.w2c.numpy(), np.asarray(j.cameras.w2c), atol=1e-6)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(t.cameras, k).numpy(),
                                      np.asarray(getattr(j.cameras, k)), err_msg=k)
    for k in ("images", "depths", "prior_depths", "normals", "confidences", "color_weights"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)),
                                      err_msg=k)
    np.testing.assert_allclose(t.curvs.numpy(), np.asarray(j.curvs), atol=1e-6)
    assert len(t.plane_masks) == len(j.plane_masks) == V + 2
    assert all(np.array_equal(a, b) for a, b in zip(t.plane_masks, j.plane_masks))
    assert t.global_plane_dict == j.global_plane_dict
    assert t.anchor_view_ids == j.anchor_view_ids == [V, V + 1]
    assert t.scale_factor == j.scale_factor
    n = int(j.scene.num_alive)
    assert int(t.scene.num_alive) == n and t.scene.capacity == j.scene.capacity
    assert t.scene.active_sh_degree == j.scene.active_sh_degree
    for k in ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
              "mip_filter"):
        np.testing.assert_array_equal(getattr(t.scene, k).numpy(),
                                      np.asarray(getattr(j.scene, k)), err_msg=k)
    # The JAX package numbers every pixel's chart point; the port gives
    # pixels of depth <= 0 id 0 (ROADMAP C12). These depths are all > 0.
    assert all(np.array_equal(a, b) for a, b in zip(t.pixel_point_ids, j.pixel_point_ids))
    jax.clear_caches()
