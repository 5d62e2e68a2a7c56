"""`G4SplatPipeline.run_sfm` from posed images on the CPU, the port's
against the JAX package's.

The scene is test_pipeline.py's `test_images_to_sfm_pipeline_integration`
one: 400 splats on the z = 0 plane seen by 3 cameras at 32², rendered by
the port's tiled rasterizer, with a calibrated source tree (`sparse/0`
written by the JAX package's COLMAP writer, `dense_view.json` naming views
0 and 2). MASt3R is TINY_CONFIG on the same seeded params in both packages
(the port's init, crossed by the JAX package's converter), config
`posed`, alignment `fast`, backend `tiled`. The iteration counts come from
the YAML overlays patched to niter1 = niter2 = 30 and 20 chart iterations
with a learning-rate boundary at 10, on both sides.

- After `run_sfm`: the cameras within 1e-5 (posed mode keeps them), the
  SfM depths within DEPTH_TOL of max|depth|, the same files, and every
  COLMAP tree (`sparse/0`, `all-sparse/0`, `dense-view-sparse/0`),
  cameras.json, pointmap and points.ply as the JAX package writes them:
  poses within 1e-5, points within DEPTH_TOL of max|point|.
(test_torch_pipeline_charts.py holds both packages' `align_charts` from one
SfM state, and test_torch_run.py runs the port's `run()` alone, on the same
scene; the three files share this one's helpers.)
"""

import json
import os

import numpy as np
import pytest
import torch

import g4splat_torch.pipeline.orchestrator as TO
import g4splat_torch.utils.config as TU
import g4splat_tpu.pipeline.orchestrator as JO
import g4splat_tpu.utils.config as JU
from g4splat_torch.convert import camera_from
from g4splat_torch.core.cameras import camera_at
from g4splat_torch.io import colmap as tcol
from g4splat_torch.io.ply import read_ply
from g4splat_torch.models.gaussians import GaussianScene
from g4splat_torch.ops.rasterize import render
from g4splat_torch.priors import mast3r as TM
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.io import colmap as jcol
from g4splat_tpu.priors import mast3r as JM

DEPTH_TOL = 1e-4
RES, N_VIEWS = 32, 3
OVERLAY = {"mast3r": dict(niter1=30, niter2=30),
           "charts_alignment": dict(n_iterations=20, lr_update_iters=[10])}
CONFIG = dict(sfm_config="posed", alignment_config="fast", train_iterations=10,
              vis_grid_resolution=0, render_backend="tiled")

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and small tensor ops on eight contended threads each run slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def scene_and_cameras():
    rng = np.random.RandomState(0)
    n = 400
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), np.zeros((n, 1))], 1).astype(np.float32)
    scene = GaussianScene.from_points(pts, rng.rand(n, 3).astype(np.float32),
                                      scales=np.full(n, 0.08, np.float32), initial_opacity=0.9,
                                      device="cpu")
    cams = []
    for i in range(N_VIEWS):
        a = (i - (N_VIEWS - 1) / 2) * 0.35
        cams.append(lookat_camera([2.2 * np.sin(a), 0.25, -2.2 * np.cos(a)], [0, 0, 0],
                                  [0, -1, 0], fx=float(RES), fy=float(RES), width=RES,
                                  height=RES))
    jc = stack_cameras(cams)
    tc = camera_from(jc, device="cpu")
    with torch.no_grad():
        images = np.stack([render(camera_at(tc, v), scene, backend="tiled")["render"].numpy()
                           for v in range(N_VIEWS)])
    return images, jc, tc


def source_tree(root, jc):
    src = os.path.join(root, "source")
    cams, imgs = {}, {}
    for v in range(N_VIEWS):
        cams[v + 1] = jcol.ColmapCamera(v + 1, "PINHOLE", RES, RES,
                                        np.array([RES, RES, (RES - 1) / 2, (RES - 1) / 2],
                                                 np.float64))
        w2c = np.asarray(jc.w2c[v])
        imgs[v + 1] = jcol.ColmapImage(v + 1, jcol.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], v + 1,
                                       f"frame_{v:06d}.png")
    jcol.write_model(cams, imgs, {}, os.path.join(src, "sparse", "0"))
    with open(os.path.join(src, "dense_view.json"), "w") as f:
        json.dump({"train": [0, 2]}, f)
    return src


def overlaid(load):
    def load_config(group, name="default"):
        return {**load(group, name), **OVERLAY.get(group, {})}
    return load_config


def mast3r_pair():
    torch.manual_seed(0)
    net = TM.AsymmetricMASt3R(TM.TINY_CONFIG)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn_like(p))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return (TM.MASt3RModel(TM.TINY_CONFIG, model=net),
            JM.MASt3RModel(JM.TINY_CONFIG, params=JM.convert_torch_mast3r(sd, JM.TINY_CONFIG)))


def written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                  for f in fs)


@pytest.fixture(scope="module")
def patched():
    mp = pytest.MonkeyPatch()
    mp.setattr(JU, "load_config", overlaid(JU.load_config))
    mp.setattr(TO, "load_config", overlaid(TU.load_config))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def front_end(tmp_path_factory, patched):
    root = str(tmp_path_factory.mktemp("front_end"))
    images, jc, tc = scene_and_cameras()
    src = source_tree(root, jc)
    tm, jm = mast3r_pair()
    jroot, troot = os.path.join(root, "jax"), os.path.join(root, "port")
    jp = JO.G4SplatPipeline(JO.PipelineConfig(source_path=src, output_path=jroot, **CONFIG),
                            JO.Priors(mast3r=jm))
    tp = TO.G4SplatPipeline(TO.PipelineConfig(source_path=src, output_path=troot, **CONFIG),
                            TO.Priors(mast3r=tm), device="cpu")
    jp.load_inputs(images, jc)
    tp.load_inputs(images, tc)
    jp.run_sfm()
    tp.run_sfm()
    return dict(jp=jp, tp=tp, jroot=jroot, troot=troot, images=images, tc=tc, src=src)


def test_run_sfm_matches_jax(front_end):
    jp, tp = front_end["jp"], front_end["tp"]
    js, ts = jp.state, tp.state
    np.testing.assert_allclose(ts.cameras.w2c.numpy(), np.asarray(js.cameras.w2c), atol=1e-5)
    np.testing.assert_allclose(ts.cameras.w2c.numpy(), front_end["tc"].w2c.numpy(), atol=1e-5)
    for k in ("fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(ts.cameras, k).numpy(),
                                   np.asarray(getattr(js.cameras, k)), rtol=1e-6)
    np.testing.assert_array_equal(ts.images.numpy(), front_end["images"])
    for k in ("depths", "prior_depths"):
        a, b = np.asarray(getattr(js, k)), getattr(ts, k)
        assert np.abs(b.numpy() - a).max() <= DEPTH_TOL * np.abs(a).max(), k
        assert bool(torch.isfinite(b).all()) and bool((b > 0).all())
    pts_tol = DEPTH_TOL * np.abs(js.sfm_points).max()
    np.testing.assert_allclose(ts.sfm_points, js.sfm_points, atol=pts_tol)
    np.testing.assert_allclose(ts.sfm_point_colors, js.sfm_point_colors, atol=1e-6)


def test_sfm_files_match_jax(front_end):
    jroot, troot = front_end["jroot"], front_end["troot"]
    names = written(troot)
    assert names == written(jroot)
    pts_tol = DEPTH_TOL * np.abs(front_end["jp"].state.sfm_points).max()
    for tree in ("sparse/0", "all-sparse/0", "dense-view-sparse/0"):
        j = tcol.read_model(os.path.join(jroot, "sfm", tree))
        t = tcol.read_model(os.path.join(troot, "sfm", tree))
        assert [list(x) for x in j] == [list(x) for x in t], tree
        for k in j[0]:
            np.testing.assert_allclose(t[0][k].params, j[0][k].params, rtol=1e-6)
        for k in j[1]:
            np.testing.assert_allclose(t[1][k].qvec, j[1][k].qvec, atol=1e-6)
            np.testing.assert_allclose(t[1][k].tvec, j[1][k].tvec, atol=1e-5)
            assert t[1][k].name == j[1][k].name
        for k in j[2]:
            np.testing.assert_allclose(t[2][k].xyz, j[2][k].xyz, atol=pts_tol)
            np.testing.assert_array_equal(t[2][k].rgb, j[2][k].rgb)
    assert len(tcol.read_model(os.path.join(troot, "sfm", "dense-view-sparse", "0"))[1]) == 2
    jc, tc = (json.load(open(os.path.join(r, "sfm", "cameras.json"))) for r in (jroot, troot))
    assert jc["filepaths"] == tc["filepaths"]
    np.testing.assert_allclose(tc["focals"], jc["focals"], rtol=1e-6)
    np.testing.assert_allclose(tc["cams2world"], jc["cams2world"], atol=1e-5)
    for v in range(N_VIEWS):
        name = os.path.join("sfm", "pointmaps", f"frame_{v:06d}.json")
        a, b = (json.load(open(os.path.join(r, name))) for r in (jroot, troot))
        assert sorted(a) == sorted(b) == ["confs", "points", "rgb"] and a["rgb"] is b["rgb"]
        np.testing.assert_allclose(b["points"], a["points"], atol=pts_tol)
        np.testing.assert_allclose(b["confs"], a["confs"], rtol=1e-5)
    a, b = (read_ply(os.path.join(r, "sfm", "points.ply"))["vertex"] for r in (jroot, troot))
    assert a.dtype == b.dtype and a.shape == b.shape
    for f in a.dtype.names:
        np.testing.assert_allclose(b[f].astype(np.float64), a[f].astype(np.float64),
                                   atol=pts_tol if f in "xyz" else 0, err_msg=f)
