"""Parity of g4splat_torch.eval and pipeline.evaluate with g4splat_tpu on the
CPU: LPIPS on carried-over params (1e-5 relative), PSNR/SSIM, the mesh
metrics (1e-6), the synthetic box room and its GT-mesh culling (bit
identical), and the results dict of `evaluate` against the JAX
orchestrator's `evaluate`, called unbound on a namespace that holds what it
reads.
"""

import contextlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g4splat_torch.convert import camera_from, lpips_params_from, scene_from
from g4splat_torch.eval import image_metrics as tim
from g4splat_torch.eval import mesh_metrics as tmm
from g4splat_torch.eval import synthetic as tsyn
from g4splat_torch.pipeline.evaluate import evaluate
from g4splat_torch.pipeline.mesh_extraction import MeshExtractionConfig, extract_mesh_adaptive_tsdf
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.eval import image_metrics as jim
from g4splat_tpu.eval import mesh_metrics as jmm
from g4splat_tpu.eval import synthetic as jsyn
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.ops.rasterize import render as jrender
from g4splat_tpu.ops.rasterize_common import RenderConfig as JRenderConfig
from g4splat_tpu.pipeline.orchestrator import G4SplatPipeline

REL = 1e-5


@pytest.fixture(scope="module")
def lpips_pair():
    params = jim.init_lpips_params(seed=0)
    return params, lpips_params_from(params, device="cpu")


def image_pairs(seed, n=2, h=48, w=64):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, h, w, 3).astype(np.float32)
    b = np.clip(a + rng.randn(n, h, w, 3) * 0.08, 0, 1).astype(np.float32)
    return a, b


class TestImageMetrics:
    def test_lpips(self, lpips_pair):
        jp, tp = lpips_pair
        a, b = image_pairs(0)
        for x, y in ((a[0], b[0]), (a[1], b[1]), (a[0], a[1])):
            j = float(jim.lpips(jp, jnp.asarray(x), jnp.asarray(y)))
            t = float(tim.lpips(tp, torch.from_numpy(x), torch.from_numpy(y)))
            assert j > 0 and abs(t - j) <= REL * j
        assert float(tim.lpips(tp, torch.from_numpy(a[0]), torch.from_numpy(a[0]))) == \
            pytest.approx(0.0, abs=1e-6)

    def test_lpips_class_and_weight_loading(self, lpips_pair):
        jp, tp = lpips_pair
        model = tim.LPIPS(tp, device="cpu")
        assert model.calibrated and not tim.LPIPS(device="cpu").calibrated
        a, b = image_pairs(1)
        j = jim.LPIPS(jp)(a[0], b[0])
        assert abs(model(a[0], b[0]) - j) <= REL * j
        # A torchvision-layout state dict loads into the same params.
        vgg = {}
        for k, idx in enumerate(tim.TV_CONV_IDX):
            vgg[f"features.{idx}.weight"] = tp["conv"][k]["w"].numpy()
            vgg[f"features.{idx}.bias"] = tp["conv"][k]["b"].numpy()
        heads = {f"lin{i}.model.1.weight": tp["lin"][i].numpy().reshape(1, -1, 1, 1)
                 for i in range(5)}
        loaded = tim.load_torch_lpips_weights(vgg, heads, device="cpu")
        assert tim.LPIPS(loaded, device="cpu")(a[0], b[0]) == model(a[0], b[0])
        ref = jim.load_torch_lpips_weights(vgg, heads)
        for x, y in zip(lpips_params_from(ref, device="cpu")["conv"], loaded["conv"]):
            assert torch.equal(x["w"], y["w"])

    def test_evaluate_images(self, lpips_pair):
        jp, tp = lpips_pair
        a, b = image_pairs(2, n=3)
        j = jim.evaluate_images(b, a, lpips_model=jim.LPIPS(jp))
        t = tim.evaluate_images(torch.from_numpy(b), a, lpips_model=tim.LPIPS(tp, device="cpu"))
        assert list(t) == list(j) == ["PSNR", "SSIM", "LPIPS"]
        for k in j:
            assert abs(t[k] - j[k]) <= REL * abs(j[k]), k
        assert list(tim.evaluate_images(b, a)) == ["PSNR", "SSIM"]


def cube_mesh():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                  [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.float32)
    f = np.array([[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4],
                  [2, 6, 3], [3, 6, 7], [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]], np.int32)
    return v, f


class TestMeshMetrics:
    def test_voxel_downsample_and_sampling(self):
        pts = np.random.RandomState(0).rand(3000, 3)
        for voxel in (0.0, 0.1, 0.25):
            np.testing.assert_array_equal(tmm.voxel_downsample(pts, voxel),
                                          jmm.voxel_downsample(pts, voxel))
        v, f = cube_mesh()
        for a, b in zip(tmm.sample_mesh_surface(v, f, 500, seed=3),
                        jmm.sample_mesh_surface(v, f, 500, seed=3)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("shift", [0.0, 0.03, 0.1])
    def test_evaluate_mesh(self, shift):
        """Dense vertex clouds (no faces), then the cube's faces for the
        normal metrics."""
        v, f = cube_mesh()
        pred = jmm.sample_mesh_surface(v, f, 20000, seed=0)[0] + np.float32(shift)
        gt = jmm.sample_mesh_surface(v, f, 20000, seed=1)[0]
        kw = dict(down_sample=0.02, n_normal_samples=5000)
        for args in ((pred, None, gt, None), (v + np.float32(shift), f, v, f)):
            j = jmm.evaluate_mesh(*args, **kw)
            t = tmm.evaluate_mesh(*args, **kw)
            assert list(t) == list(j)
            for k in j:
                assert t[k] == pytest.approx(j[k], abs=1e-6, rel=1e-6), k
        assert "Normal-Consistency" in t


class TestSynthetic:
    def test_box_room_bit_identical(self):
        js, (jv, jf) = jsyn.box_room(400)
        ts, (tv, tf) = tsyn.box_room(400, device="cpu")
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        for k in ("xyz", "f_dc", "f_rest", "opacity_raw", "scaling_raw", "rotation_raw",
                  "alive"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)))

    def test_room_cameras_and_cull(self):
        jc = jsyn.room_cameras(4, 48, 36)
        tc = tsyn.room_cameras(4, 48, 36, device="cpu")
        for k in ("w2c", "fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
                                       atol=1e-6, rtol=0)
        js, (verts, faces) = jsyn.box_room(400)
        depths = []
        for i in range(4):
            out = jrender(jax.tree.map(lambda x, i=i: x[i], jc), js, backend="tiled")
            d = np.array(out["surf_depth"])
            d[d <= 0] = 3.2
            depths.append(d)
        depths = np.stack(depths)
        jv, jf = jsyn.cull_mesh_to_views(verts, faces, jc, depths)
        tv, tf = tsyn.cull_mesh_to_views(verts, faces, camera_from(jc, device="cpu"), depths)
        assert 0 < len(jf) < len(faces)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def sphere(n=400):
    rng = np.random.RandomState(0)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return JScene.from_points((0.5 * d).astype(np.float32), np.full((n, 3), 0.7, np.float32),
                              scales=np.full(n, 0.08, np.float32), initial_opacity=0.95)


def ring(k, offset=0.0):
    return stack_cameras([lookat_camera([2.5 * np.cos(a), 0.2, 2.5 * np.sin(a)], [0, 0, 0],
                                        [0, -1, 0], fx=50.0, fy=50.0, width=64, height=48)
                          for a in offset + np.arange(k) * 2 * np.pi / k])


def test_evaluate_matches_orchestrator(tmp_path, lpips_pair):
    jp, tp = lpips_pair
    js = sphere()
    jc, jt = ring(3), ring(2, offset=0.4)
    rng = np.random.RandomState(7)
    gt_images = rng.rand(3, 48, 64, 3).astype(np.float32)
    test_images = rng.rand(2, 48, 64, 3).astype(np.float32)
    cfg = MeshExtractionConfig(downsample_ratio=0.5, n_binary_steps=3, backend="tiled",
                               point_chunk=16384)
    mesh = extract_mesh_adaptive_tsdf(scene_from(js, device="cpu"),
                                      camera_from(jc, device="cpu"), cfg)
    gt_mesh = tsyn.cull_mesh_to_views(mesh.vertices + np.float32(0.01), mesh.faces,
                                      camera_from(jc, device="cpu"), np.full((3, 48, 64), 9.0))

    def render_batch(cams, n, out_dir):
        return np.stack([np.asarray(jrender(jax.tree.map(lambda x, v=v: x[v], cams), js,
                                            config=JRenderConfig(compute_distortion=False),
                                            backend="tiled")["render"]) for v in range(n)])

    (tmp_path / "j").mkdir()
    ns = types.SimpleNamespace(
        state=types.SimpleNamespace(test_images=test_images, test_cameras=jt),
        cfg=types.SimpleNamespace(train_iterations=30, output_path=str(tmp_path / "j")),
        priors=types.SimpleNamespace(lpips=None),
        store=types.SimpleNamespace(renders_dir=lambda split, it: str(tmp_path)),
        _timed=lambda name: contextlib.nullcontext(),
        _render_camera_batch=render_batch,
        render_all=lambda it, include_test=False: render_batch(jc, 3, None),
        extract_mesh=lambda: mesh)
    j = G4SplatPipeline.evaluate(ns, gt_images=gt_images, gt_mesh=gt_mesh,
                                 lpips_model=jim.LPIPS(jp, calibrated=False))
    t = evaluate(scene_from(js, device="cpu"), camera_from(jc, device="cpu"), gt_images,
                 gt_mesh, test_cameras=camera_from(jt, device="cpu"), test_images=test_images,
                 lpips_model=tim.LPIPS(tp, calibrated=False, device="cpu"),
                 out_dir=str(tmp_path / "t"), mesh=mesh, iteration=30, backend="tiled")
    assert list(t) == list(j)
    assert t["LPIPS-uncalibrated"] is True and t["test_views_num"] == 2
    for k, v in j.items():
        if isinstance(v, float):
            assert t[k] == pytest.approx(v, rel=REL, abs=1e-5), k
        else:
            assert t[k] == v, k
    for k in ("Average-PSNR", "Average-SSIM", "Average-LPIPS"):
        assert t[k] == round(t[k], 5)
    written = json.loads((tmp_path / "t" / "result_iter_30.json").read_text())
    assert list(written) == list(json.loads((tmp_path / "j" / "result_iter_30.json").read_text()))
    assert (tmp_path / "t" / "result_iter_30.txt").read_text().splitlines()[0].startswith(
        "LPIPS-uncalibrated: True")
    assert len(list((tmp_path / "t" / "test" / "ours_30" / "renders").iterdir())) == 2


def test_evaluate_extracts_the_mesh(tmp_path):
    js = sphere(300)
    ts, tc = scene_from(js, device="cpu"), camera_from(ring(3), device="cpu")
    cfg = MeshExtractionConfig(downsample_ratio=0.5, n_binary_steps=2, backend="tiled",
                               texture_mesh=False)
    mesh = extract_mesh_adaptive_tsdf(ts, tc, cfg)
    t = evaluate(ts, tc, gt_mesh=(mesh.vertices, mesh.faces), out_dir=str(tmp_path),
                 iteration=5, backend="tiled", mesh_config=cfg)
    assert t["Chamfer-L1"] == pytest.approx(0.0, abs=1e-6) and t["LPIPS-uncalibrated"]
    assert (tmp_path / "meshes" / "tetra_mesh_binary_search_7_iter_5.ply").exists()


def test_evaluate_extracts_with_its_backend(monkeypatch):
    """One `backend` decides both the image renders and the extraction's
    views, whatever backend `mesh_config` names."""
    import g4splat_torch.pipeline.evaluate as tev

    seen = []

    tri = (np.eye(3, dtype=np.float32), np.array([[0, 1, 2]], np.int32))

    def extract(scene, cameras, config):
        seen.append(config.backend)
        return tev.ExtractedMesh(*tri, None)

    monkeypatch.setattr(tev, "extract_mesh_adaptive_tsdf", extract)
    js = sphere(100)
    ts, tc = scene_from(js, device="cpu"), camera_from(ring(3), device="cpu")
    evaluate(ts, tc, gt_mesh=tri, backend="tiled",
             mesh_config=MeshExtractionConfig(backend="cuda"))
    assert seen == ["tiled"]
