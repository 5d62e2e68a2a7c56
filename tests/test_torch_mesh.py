"""Parity of g4splat_torch's mesh extraction with g4splat_tpu on the CPU:
tetra points, Delaunay / cube-grid cells and marching tetrahedra (exactly
equal), render_all_views (1e-4 on the tiled backend), the adaptive, multires
and grid extractions on tests/test_mesh.py's sphere scenes, the cluster,
coverage and edge-length filters (1e-6), the config key mapping, mesh PLY
files, and render_camera_batch's PNGs.

The extractions run the JAX package end to end on the CPU. Port and JAX
meshes must agree: face counts within 1 %, the symmetric vertex Chamfer
distance under 1e-3 × the sphere radius, and under 1 % of the crossing
edges' binary searches ending elsewhere (a midpoint whose TSDF sits at 0 can
go either way).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from g4splat_torch.convert import camera_from, scene_from
from g4splat_torch.io import images as timg
from g4splat_torch.io import ply as tply
from g4splat_torch.ops import tetra as ttet
from g4splat_torch.pipeline import mesh_extraction as tme
from g4splat_torch.pipeline.render_all import render_all, render_camera_batch
from g4splat_tpu.core.cameras import lookat_camera, stack_cameras
from g4splat_tpu.io import ply as jply
from g4splat_tpu.models.gaussians import GaussianScene as JScene
from g4splat_tpu.ops import rasterize as jrast
from g4splat_tpu.ops import tetra as jtet
from g4splat_tpu.pipeline import mesh_extraction as jme
from g4splat_tpu.pipeline import orchestrator as jorch
from g4splat_tpu.utils.config import apply_overrides

RADIUS = 0.5


def sphere_arrays(n=800, r=RADIUS, seed=0):
    """tests/test_mesh.py::sphere_scene's arrays."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * r).astype(np.float32), np.full((n, 3), 0.7, np.float32)


def sphere_scene(n=800):
    pts, cols = sphere_arrays(n)
    j = JScene.from_points(pts, cols, scales=np.full(n, 0.08, np.float32),
                           initial_opacity=0.95)
    return j, scene_from(j, device="cpu")


def ring_cameras(k, f, w, y):
    j = stack_cameras([lookat_camera([2.5 * np.cos(a), y, 2.5 * np.sin(a)], [0, 0, 0],
                                     [0, -1, 0], fx=f, fy=f, width=w, height=w)
                       for a in np.arange(k) * 2 * np.pi / k])
    return j, camera_from(j, device="cpu")


def meshes_agree(t, j, radius=RADIUS):
    assert len(j.faces) > 200
    assert abs(len(t.faces) - len(j.faces)) <= 0.01 * len(j.faces)
    d1 = cKDTree(j.vertices).query(t.vertices)[0]
    d2 = cKDTree(t.vertices).query(j.vertices)[0]
    assert (d1.mean() + d2.mean()) / 2 < 1e-3 * radius
    if len(t.vertices) == len(j.vertices):      # the same crossing edges, in order
        moved = np.abs(t.vertices - j.vertices).max(1) > 1e-5 * radius
        assert moved.mean() < 0.01
    assert np.isfinite(t.vertices).all()
    if j.vertex_colors is not None:
        assert t.vertex_colors.shape == t.vertices.shape
        assert (t.vertex_colors >= 0).all() and (t.vertex_colors <= 1).all()


# ------------------------------------------------------------------ host ops
class TestHostOps:
    def test_tetra_points_with_non_finite_rows(self):
        js, ts = sphere_scene(300)
        xyz = np.array(js.xyz)
        xyz[5] = np.nan
        scaling_raw = np.array(js.scaling_raw)
        scaling_raw[7] = np.inf                    # exp overflows
        rot = np.random.RandomState(1).randn(*np.asarray(js.rotation_raw).shape)
        js = js.replace(xyz=xyz, scaling_raw=scaling_raw, rotation_raw=rot.astype(np.float32))
        ts = scene_from(js, device="cpu")
        for ratio in (1.0, 0.5):
            jp, jsc = js.tetra_points(downsample_ratio=ratio, flatness=1e-3, seed=3)
            tp, tsc = ts.tetra_points(downsample_ratio=ratio, flatness=1e-3, seed=3)
            assert tp.shape == jp.shape and tsc.shape == jsc.shape
            assert np.isfinite(tp).all()
            np.testing.assert_allclose(tp, jp, atol=1e-6, rtol=0)
            np.testing.assert_allclose(tsc, jsc, atol=1e-6, rtol=0)

    def test_cells_and_marching_equal(self):
        rng = np.random.RandomState(0)
        pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
        cells = ttet.delaunay_tetrahedralize(pts)
        np.testing.assert_array_equal(cells, jtet.delaunay_tetrahedralize(pts))
        sdf = (0.6 - np.linalg.norm(pts, axis=1)).astype(np.float32)
        scales = rng.rand(len(pts)).astype(np.float32)
        for a, b in zip(ttet.marching_tetrahedra(pts, cells, sdf, scales),
                        jtet.marching_tetrahedra(pts, cells, sdf, scales)):
            np.testing.assert_array_equal(a, b)
        ts, tt = ttet.cube_grid_to_tets((5, 6, 7))
        js_, jt = jtet.cube_grid_to_tets((5, 6, 7))
        assert ts == js_
        np.testing.assert_array_equal(tt, jt)
        g = np.stack(np.meshgrid(*(np.linspace(-1, 1, n) for n in (5, 6, 7)),
                                 indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
        gsdf = (0.7 - np.linalg.norm(g, axis=1)).astype(np.float32)
        ones = np.ones(len(g), np.float32)
        for a, b in zip(ttet.marching_tetrahedra(g, tt, gsdf, ones),
                        jtet.marching_tetrahedra(g, jt, gsdf, ones)):
            np.testing.assert_array_equal(a, b)

    def test_keep_largest_clusters_and_edge_filter(self):
        rng = np.random.RandomState(2)
        pts = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
        cells = jtet.delaunay_tetrahedralize(pts)
        sdf = (0.5 - np.abs(np.linalg.norm(pts, axis=1) - 0.5)).astype(np.float32) - 0.35
        mt = jtet.marching_tetrahedra(pts, cells, sdf, np.ones(len(pts), np.float32))
        verts = mt.edge_verts.mean(1).astype(np.float32)
        cols = rng.rand(len(verts), 3).astype(np.float32)
        jm = jme.ExtractedMesh(verts, mt.faces, cols)
        tm = tme.ExtractedMesh(verts, mt.faces, cols)
        for keep, min_tri in ((50, 50), (2, 5), (1, 1)):
            a = tme.keep_largest_clusters(tm, keep, min_tri)
            b = jme.keep_largest_clusters(jm, keep, min_tri)
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
        for thr in (0.5, 0.2):
            a = tme.filter_mesh_by_edge_length(tm, thr)
            b = jorch.filter_mesh_by_edge_length(jm, thr)
            assert 0 < len(a.faces) <= len(tm.faces)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_verts_covered(self):
        jc, tc = ring_cameras(3, 30.0, 32, 0.2)
        verts = np.random.RandomState(4).uniform(-3, 3, (2000, 3)).astype(np.float32)
        for trunc in (2.0, 3.0):
            got = tme._verts_covered(tc, verts, trunc)
            np.testing.assert_array_equal(got, jme._verts_covered(jc, verts, trunc))
            assert 0 < got.mean() < 1

    def test_config_mapping_and_extent(self):
        from g4splat_tpu.utils.config import load_config

        ycfg = dict(load_config("adaptive_tetrahedralization", "default"))
        ycfg.update(use_unbiased_tsdf=True, n_neighbors_to_interpolate=3,
                    n_interpolated_cameras_for_each_neighbor=4)
        j = dict(ycfg)
        for src, dst in tme.REFERENCE_KEYS:
            j[dst] = j.pop(src)
        jcfg = apply_overrides(jme.MeshExtractionConfig(downsample_ratio=0.5,
                                                        use_interpolated_views=True), j)
        tcfg = tme.mesh_config_from(ycfg, tme.PRODUCTION_MESH_CONFIG)
        for f in tcfg.__dataclass_fields__:
            if f != "backend":
                assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert tcfg.backend == "cuda" and jcfg.backend == "pallas"
        # The production config is the default YAML over the orchestrator's base.
        prod = apply_overrides(jme.MeshExtractionConfig(downsample_ratio=0.5,
                                                        use_interpolated_views=True),
                               dict(load_config("adaptive_tetrahedralization", "default")))
        for f in tcfg.__dataclass_fields__:
            if f != "backend":
                assert getattr(tme.PRODUCTION_MESH_CONFIG, f) == getattr(prod, f), f
        jc, tc = ring_cameras(5, 30.0, 32, 0.2)
        assert tme.cameras_spatial_extent(tc) == pytest.approx(
            jme.cameras_spatial_extent(jc), abs=1e-6)


# ---------------------------------------------------------------- rendering
def test_render_all_views_tiled():
    js, ts = sphere_scene(400)
    js = js.replace(active_sh_degree=1)
    ts = ts.replace(active_sh_degree=1)
    jc, tc = ring_cameras(3, 40.0, 40, 0.2)
    j = jme.render_all_views(js, jc, 1.0, backend="tiled")
    t = tme.render_all_views(ts, tc, 1.0, backend="tiled")
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    t0 = tme.render_all_views(ts, tc, 1.0, backend="tiled", sh_degree=0)
    j0 = jme.render_all_views(js, jc, 1.0, backend="tiled", sh_degree=0)
    np.testing.assert_allclose(t0.rgbs.numpy(), np.asarray(j0[0]), atol=1e-4, rtol=0)


def test_render_camera_batch_writes_pngs(tmp_path):
    from PIL import Image

    js, ts = sphere_scene(300)
    jc, tc = ring_cameras(3, 40.0, 40, 0.2)
    renders = render_camera_batch(ts, tc, str(tmp_path / "r"), backend="tiled")
    assert renders.shape == (3, 40, 40, 3)
    for v in range(3):
        cam = jax.tree.map(lambda x, v=v: x[v], jc)
        ref = np.asarray(jrast.render(cam, js, config=jrast.RenderConfig(
            compute_distortion=False), backend="tiled")["render"])
        np.testing.assert_allclose(renders[v].numpy(), ref, atol=1e-4, rtol=0)
        path = tmp_path / "r" / f"{v:05d}.png"
        want = (np.clip(renders[v].numpy(), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), want)
        np.testing.assert_array_equal(timg.read_png(str(path)), want)
    out = render_all(ts, tc, 30, out_root=str(tmp_path), test_cameras=tc, backend="tiled")
    assert torch.equal(out, renders)
    assert sorted(p.name for p in (tmp_path / "test" / "ours_30" / "renders").iterdir()) == [
        "00000.png", "00001.png", "00002.png"]


def test_png_writer(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(5)
    for shape in ((7, 5, 3), (6, 9), (4, 3, 4)):
        img = rng.rand(*shape).astype(np.float32) * 1.2 - 0.1
        timg.save_image(str(tmp_path / "a.png"), img)
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), want)
        np.testing.assert_array_equal(timg.read_png(str(tmp_path / "a.png")), want)
    timg.save_image_async(str(tmp_path / "b.png"), torch.from_numpy(img))
    timg.flush_io()
    assert timg.read_png(str(tmp_path / "b.png")).shape == (4, 3, 4)
    Image.fromarray(want).save(tmp_path / "pil.png")
    with pytest.raises(ValueError):
        timg.read_png(str(tmp_path / "pil.png"))   # PIL's rows use other filters


def test_mesh_ply_round_trip(tmp_path):
    rng = np.random.RandomState(6)
    v = rng.randn(40, 3).astype(np.float32)
    f = rng.randint(0, 40, (60, 3)).astype(np.int32)
    c = rng.rand(40, 3).astype(np.float32)
    tply.save_mesh_ply(str(tmp_path / "t.ply"), v, f, c)
    jply.save_mesh_ply(str(tmp_path / "j.ply"), v, f, c)
    tv, tf, tc = tply.load_mesh_ply(str(tmp_path / "t.ply"))
    jv, jf, jc = jply.load_mesh_ply(str(tmp_path / "t.ply"))
    for a, b in ((tv, jv), (tf, jf), (tc, jc), (tv, v), (tf, f)):
        np.testing.assert_array_equal(a, b)
    got, ref = tply.read_ply(str(tmp_path / "j.ply")), jply.read_ply(str(tmp_path / "t.ply"))
    assert got["vertex"].tobytes() == ref["vertex"].tobytes()
    np.testing.assert_array_equal(got["face"], ref["face"])
    tply.save_mesh_ply(str(tmp_path / "n.ply"), v, f)
    assert tply.load_mesh_ply(str(tmp_path / "n.ply"))[2] is None


# -------------------------------------------------------- whole extractions
@pytest.mark.parametrize("port_backend", ["tiled", "cuda"])
def test_adaptive_tsdf_sphere(port_backend):
    """test_mesh.py::test_adaptive_tsdf_sphere's scene. The port also runs
    its cuda backend, which on CPU tensors is kernel B1's plain version."""
    js, ts = sphere_scene(400)
    jc, tc = ring_cameras(4, 40.0, 40, 0.2)
    kw = dict(downsample_ratio=0.5, n_binary_steps=4, texture_mesh=True, point_chunk=16384)
    jm = jme.extract_mesh_adaptive_tsdf(js, jc, jme.MeshExtractionConfig(backend="tiled", **kw))
    timings = {}
    tm = tme.extract_mesh_adaptive_tsdf(ts, tc, tme.MeshExtractionConfig(backend=port_backend,
                                                                         **kw),
                                        timings=timings)
    meshes_agree(tm, jm)
    assert {"tetra_points", "delaunay", "render_all_views", "tsdf", "marching",
            "binary_step_3", "render_all_views_sh0", "colors"} <= set(timings)


def test_adaptive_tsdf_interpolated_views():
    js, ts = sphere_scene(300)
    jc, tc = ring_cameras(3, 32.0, 32, 0.2)
    kw = dict(downsample_ratio=0.5, n_binary_steps=3, texture_mesh=False, point_chunk=8192,
              use_interpolated_views=True, interp_neighbors=2, interp_per_neighbor=1)
    jm = jme.extract_mesh_adaptive_tsdf(js, jc, jme.MeshExtractionConfig(backend="tiled", **kw))
    tm = tme.extract_mesh_adaptive_tsdf(ts, tc, tme.MeshExtractionConfig(backend="tiled", **kw))
    meshes_agree(tm, jm)
    assert tm.vertex_colors is None


def test_multires_tsdf_sphere():
    js, ts = sphere_scene()
    jc, tc = ring_cameras(6, 48.0, 48, 0.3)
    kw = dict(factors=(2.0, 8.0, 16.0), resolution=32, backend="tiled", point_chunk=65536)
    meshes_agree(tme.extract_mesh_multires_tsdf(ts, tc, **kw),
                 jme.extract_mesh_multires_tsdf(js, jc, **kw))


def test_grid_tsdf_sphere():
    js, ts = sphere_scene()
    jc, tc = ring_cameras(6, 48.0, 48, 0.3)
    kw = dict(resolution=32, backend="tiled", carve_empty=True,
              bounds=np.array([[-0.9] * 3, [0.9] * 3]))
    meshes_agree(tme.extract_mesh_grid_tsdf(ts, tc, **kw),
                 jme.extract_mesh_grid_tsdf(js, jc, **kw))
